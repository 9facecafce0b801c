"""Microsecond cost model for the simulated RDMA fabric.

Every constant is taken from (or derived to match) a specific measurement in
the KRCORE paper (Wei et al.); the citation is given next to each value.
Times are microseconds, sizes are bytes, unless stated otherwise.

The testbed being modeled (paper §5): 10 nodes, 2x12-core Xeon E5-2650 v4,
ConnectX-4 100 Gbps InfiniBand, SB7890 switch, one meta server.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    # ------------------------------------------------------------------
    # Fabric / data path
    # ------------------------------------------------------------------
    #: One-way wire+switch propagation for a small message. Chosen so that an
    #: 8B one-sided READ RTT lands at ~2 us (Fig 3a "Verbs data"; §1 "the
    #: latency of its data path has reached a few microseconds").
    wire_us: float = 0.6
    #: RNIC per-request processing (issue + completion DMA), per side.
    nic_op_us: float = 0.35
    #: Extra per-request processing for DCT (larger address header + connect
    #: piggyback) — calibrated so DC peak throughput is ~8.9% below RC
    #: (Fig 10 discussion: "the peak throughput is 8.9% lower").
    dct_op_extra_us: float = 0.034
    #: DCT hardware (re)connect cost, charged on the first request to a new
    #: peer after idle/disconnect (§3: "measured overhead is less than 1us").
    dct_connect_us: float = 0.8
    #: Link bandwidth: 100 Gbps InfiniBand (§5 testbed) = 12.5 GB/s -> us/B.
    link_bytes_per_us: float = 12_500.0
    #: Host memcpy bandwidth for kernel-buffer -> user-buffer copies in the
    #: two-sided non-zero-copy path (~20 GB/s, one core).
    memcpy_bytes_per_us: float = 20_000.0
    #: Syscall / kernel-crossing overhead added by KRCORE to each data-path
    #: call. Fig 12a factor analysis: "System call introduces 1us latency"
    #: for a complete op (= one qpush + one qpop), i.e. ~0.5us per crossing.
    syscall_us: float = 0.5
    #: Additional latency when the request's MR is not in MRStore and a
    #: remote ValidMR check is required (Fig 12a: "+4.54us").
    mr_check_miss_us: float = 4.54
    #: Request pre-check (opcode + MR bounds; §3.1 C#3 "negligible").
    precheck_us: float = 0.02
    #: Server-side RPC handler service time per two-sided message (one core,
    #: FaSST-style; used for echo servers and RPC-based metadata query).
    rpc_handler_us: float = 1.1

    # ------------------------------------------------------------------
    # User-space Verbs control path (Fig 2, Fig 3b; §2.2.1)
    # ------------------------------------------------------------------
    #: Driver context init (device list, open device, alloc PD, ...).
    #: Fig 3b: control path totals ~15.7ms and is NOT dominated by handshake;
    #: ConnectX-6 still takes 17ms (§6). Init is the software+firmware part
    #: that each fresh user process pays once.
    verbs_init_us: float = 13_800.0
    #: create_qp: 413us total, 87% of it waiting on the NIC (361us) —
    #: §2.2.1 "87% of the create_qp time (361us vs. 413us)".
    create_qp_sw_us: float = 52.0
    create_qp_nic_us: float = 361.0
    #: create_cq, same shape of cost (measured smaller than QP).
    create_cq_sw_us: float = 30.0
    create_cq_nic_us: float = 190.0
    #: modify_qp INIT->RTR and RTR->RTS both hit the NIC command interface.
    #: Derived so that LITE's optimized path (no Init; create+configure only)
    #: serializes at ~1.4ms/QP -> 712 QPs/sec (Fig 3, §2.2.2 Issue#1).
    modify_qp_rtr_nic_us: float = 520.0
    modify_qp_rts_nic_us: float = 330.0
    #: Connection-info handshake over RDMA connectionless datagram (UD):
    #: 2.4% of the 15.7ms total (§2.2.1) = ~380us (includes GID/LID exchange
    #: and an RTT on the slow path).
    handshake_us: float = 380.0
    #: reg_mr for a small buffer (§2.2.1 footnote: "50us for 4KB").
    reg_mr_4kb_us: float = 50.0
    #: reg_mr scales with pages pinned; ~per-MB incremental cost.
    reg_mr_per_mb_us: float = 14.0

    # ------------------------------------------------------------------
    # KRCORE control path (Table 2)
    # ------------------------------------------------------------------
    queue_us: float = 0.36          # Table 2: queue()
    qconnect_rc_hit_us: float = 0.9  # Table 2: qconnect w/ RCQP
    qconnect_dc_cached_us: float = 0.9  # Table 2: qconnect w/ DCCache
    qbind_us: float = 0.39          # Table 2: qbind
    qreg_mr_4mb_us: float = 1.4     # Table 2: qreg_mr w/ 4MB DRAM
    #: Meta-server lookup = DrTM-KV one-sided READ(s); "lookup in DrTM-KV
    #: only takes one one-sided RDMA READ in the common case" (§4.3).
    meta_lookup_reads: int = 1

    # ------------------------------------------------------------------
    # Memory footprints (§2.2.2 Issue#2, Fig 13a)
    # ------------------------------------------------------------------
    #: Bytes per RCQP: 292 sq entries x 448B + 257 cq entries x 64B, rounded
    #: to hardware granularity => "at least 159KB" (§2.2.2 footnote 4).
    rcqp_bytes: int = 159 * 1024
    #: DCT metadata per remote node: "12B is sufficient" (§3.1 C#1).
    dct_meta_bytes: int = 12
    #: DCQP itself (one per pool by default) — same queue sizing as RC.
    dcqp_bytes: int = 159 * 1024
    #: sq/cq entry sizes and depths (footnote 4) — also used as the default
    #: physical queue depths in the simulator.
    sq_entry_bytes: int = 448
    cq_entry_bytes: int = 64
    sq_depth: int = 292
    cq_depth: int = 257
    #: UD MTU: max payload of a connectionless datagram (meta/handshake).
    ud_mtu: int = 4096
    #: Kernel pre-posted receive-buffer size for two-sided messages (§4.5:
    #: payloads beyond this take the zero-copy path).
    kernel_msg_buf_bytes: int = 4096

    # ------------------------------------------------------------------
    # Process / application layer (Fig 14, §5.3)
    # ------------------------------------------------------------------
    #: Warm container/process start (§1: "start container from a warm state"
    #: is ~1ms-scale [35]; Fig 14: KRCORE run is "bottlenecked by creating
    #: worker processors": 180 workers in 244ms => ~1.35ms each).
    fork_worker_us: float = 1_350.0
    #: MRStore invalidation flush period (§4.2: "periodically (e.g. 1s)").
    mr_flush_period_us: float = 1_000_000.0

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    def payload_us(self, nbytes: int) -> float:
        """Serialization time of ``nbytes`` on the 100Gbps link."""
        return nbytes / self.link_bytes_per_us

    def memcpy_us(self, nbytes: int) -> float:
        return nbytes / self.memcpy_bytes_per_us

    def reg_mr_us(self, nbytes: int) -> float:
        mb = nbytes / (1024.0 * 1024.0)
        return self.reg_mr_4kb_us + self.reg_mr_per_mb_us * mb

    def verbs_create_us(self) -> float:
        """create_qp + create_cq software+NIC time (no queueing)."""
        return (self.create_qp_sw_us + self.create_qp_nic_us
                + self.create_cq_sw_us + self.create_cq_nic_us)

    def verbs_configure_us(self) -> float:
        return self.modify_qp_rtr_nic_us + self.modify_qp_rts_nic_us

    def verbs_control_total_us(self) -> float:
        """Full user-space control path for the first connection (~15.7ms)."""
        return (self.verbs_init_us + self.verbs_create_us()
                + self.verbs_configure_us() + self.handshake_us
                + self.reg_mr_4kb_us)

    def lite_connect_us(self) -> float:
        """Optimized-LITE per-RCQP cost (~1.4ms serialized at the NIC)."""
        return (self.verbs_create_us() + self.verbs_configure_us()
                + self.handshake_us)


DEFAULT = CostModel()


def validate(cm: CostModel = DEFAULT) -> dict:
    """Sanity numbers the paper states, used by tests."""
    return {
        "verbs_control_ms": cm.verbs_control_total_us() / 1e3,   # ~15.7
        "lite_connect_ms": cm.lite_connect_us() / 1e3,           # ~2 (Fig 3)
        "lite_qps_per_sec": 1e6 / (cm.create_qp_nic_us + cm.create_cq_nic_us
                                   + cm.modify_qp_rtr_nic_us
                                   + cm.modify_qp_rts_nic_us),   # ~712
        "read_8b_rtt_us": 2 * cm.wire_us + 2 * cm.nic_op_us
                          + cm.payload_us(8),                    # ~2
    }
