from .race import (NSLOT, STATE_FROZEN, STATE_MOVED, STATE_OFF, STATE_SERVING,
                   DeviceRaceTable, ShardedDeviceRaceTable, parse_state,
                   shard_of_key, state_word)

__all__ = ["NSLOT", "STATE_FROZEN", "STATE_MOVED", "STATE_OFF",
           "STATE_SERVING", "DeviceRaceTable", "ShardedDeviceRaceTable",
           "parse_state", "shard_of_key", "state_word"]
