from .race import (CLAIMED, NSLOT, SLOT_BYTES, STATE_FROZEN, STATE_MOVED,
                   STATE_OFF, STATE_SERVING, DeviceRaceTable, RaceClient,
                   RaceKVStore, ShardClient, ShardedDeviceRaceTable,
                   parse_state, shard_of_key, state_word)

__all__ = ["CLAIMED", "NSLOT", "SLOT_BYTES", "STATE_FROZEN", "STATE_MOVED",
           "STATE_OFF", "STATE_SERVING", "DeviceRaceTable", "RaceClient",
           "RaceKVStore", "ShardClient", "ShardedDeviceRaceTable",
           "parse_state", "shard_of_key", "state_word"]
