"""The port's MoE FFN (``repro_torch/models/moe.py``) and olmoe against the
JAX package on the CPU.

Module level, on identical inputs: ``router_topk`` and ``_route`` (``idx``,
``pos`` and ``keep`` exact, with the capacity and its drops), the blocked
and the flat exclusive cumsum, ``load_balance_loss``, and ``moe_ffn_gather``
against JAX's and against the port's own one-hot oracle ``moe_ffn_einsum``.
The combine equals XLA's scatter-add bit for bit in bfloat16 on the same
slot outputs: the port adds each token's expert outputs in the order of
their expert ids, the order in which XLA's scatter-add applies them. (The
whole bf16 FFN may still differ from JAX's by a bf16 ulp where a float32
routing weight, one float32 ulp off, rounds to the other bf16 neighbour.)

Model level: olmoe's smoke config through ``forward_full``, ``prefill`` and
8 ``decode_step``s (see ``test_torch_models.py``). In bfloat16 the router's
input differs from JAX's by bf16 roundings upstream (the CPU's bf16
matrix products round differently in the two libraries), and at a near-tie
between the k-th and the (k+1)-th expert that can flip a choice, which then
changes that token's whole FFN output. :class:`FollowJaxAtNearTies` holds
every routing decision of the port equal to JAX's, except where the two
picks differ by less than the two packages' own probability disagreement
(a near-tie); there the port goes on with JAX's pick, so that both models
compute the same function downstream and stay comparable at 3e-2.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.moe as jmoe
import repro_torch.models.moe as tmoe
from repro import configs as jconfigs
from repro.models import params as jparams
from repro.models.common import KeyGen
from repro_torch import configs as tconfigs
from test_torch_models import _close, check_forward_prefill_decode

ARCH = "olmoe_1b_7b"


class FollowJaxAtNearTies:
    """Pairs each call of the port's ``router_topk`` with JAX's call of the
    same step (JAX runs first in every pair of calls of the model checks).
    The two packages' router probabilities must agree within ``tol`` a
    row; a row whose chosen experts differ must be a near-tie: the port's
    probabilities of the two picks may differ by at most twice the row's
    disagreement (a flip that disagreement cannot explain is a fault). At
    such a row the port takes JAX's experts, weighted by its own
    probabilities. ``flips`` lists (call, row, gap, disagreement), and
    :meth:`done` fails if there are more than ``max_flips`` of them;
    ``worst`` is the largest disagreement seen."""

    def __init__(self, monkeypatch, tol: float, max_flips: int):
        self.max_flips = max_flips
        self.pending = collections.deque()
        self.flips = []
        self.calls = 0
        self.worst = 0.0
        jax_topk, port_topk = jmoe.router_topk, tmoe.router_topk

        def jax_side(logits, k, renormalize=True):
            w, idx = jax_topk(logits, k, renormalize)
            self.pending.append((np.asarray(logits, np.float32),
                                 np.asarray(idx)))
            return w, idx

        def port_side(logits, k, renormalize=True):
            jlogits, jidx = self.pending.popleft()
            w, idx = port_topk(logits, k, renormalize)
            probs = torch.softmax(logits.float(), dim=-1)
            jprobs = np.asarray(jax.nn.softmax(jnp.asarray(jlogits), -1))
            dis = np.abs(probs.numpy() - jprobs).max(-1)
            self.worst = max(self.worst, float(dis.max()))
            assert dis.max() <= tol, f"router probabilities differ by " \
                f"{dis.max()} (call {self.calls})"
            mine, theirs = np.sort(idx.numpy(), -1), np.sort(jidx, -1)
            rows = np.flatnonzero((mine != theirs).any(-1))
            for r in rows:
                p = probs[r].numpy()
                a = np.setdiff1d(mine[r], theirs[r])
                b = np.setdiff1d(theirs[r], mine[r])
                gap = float(np.abs(p[a][:, None] - p[b][None, :]).max())
                assert gap <= 2 * dis[r], \
                    f"call {self.calls} row {r}: a flip with gap {gap} " \
                    f"beyond the disagreement {dis[r]}"
                self.flips.append((self.calls, int(r), gap, float(dis[r])))
            self.calls += 1
            if rows.size == 0:
                return w, idx
            jt = torch.from_numpy(jidx).long()
            w = torch.gather(probs, -1, jt)
            if renormalize:
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            return w, jt

        monkeypatch.setattr(jmoe, "router_topk", jax_side)
        monkeypatch.setattr(tmoe, "router_topk", port_side)

    def done(self):
        assert not self.pending and self.calls > 0
        assert len(self.flips) <= self.max_flips, \
            f"{len(self.flips)} routing flips: {self.flips}"
        return self.flips


def _cfgs(arch=ARCH, **kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **kw)
    return jcfg, tcfg


def _route_inputs(t, d, e, seed, bias=0.0):
    """Tokens and a float32 router; ``bias`` pulls every token towards
    expert 0 (a shared feature times a large router weight), so that it
    overflows its capacity."""
    rng = np.random.RandomState(seed)
    xt = rng.randn(t, d).astype(np.float32)
    router = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    if bias:
        xt[:, 0] = 1.0
        router[0, 0] = bias
    return xt, router


@pytest.mark.parametrize("t,d,e,k,cf,blocked,bias,drops", [
    (64, 64, 4, 2, 1.25, False, 3.0, True),      # olmoe smoke, default cap
    (64, 64, 4, 2, 1.25, True, 3.0, True),
    (64, 64, 4, 2, 1000.0, False, 3.0, False),   # the consistency's cap
    (300, 32, 64, 8, 1.25, True, 0.0, None),     # olmoe's E, K; 2,400 rows
    (3, 16, 160, 6, 1.25, True, 0.0, False),     # deepseek decode: cap 3
    (512, 16, 16, 2, 0.5, True, 0.0, True),
])
def test_route_equals_jax_exactly(t, d, e, k, cf, blocked, bias, drops):
    """``_route`` on identical float32 inputs: ``idx``, ``pos``, ``keep``
    and the capacity exactly, the weights and the aux loss at float32
    rounding; ``drops`` says whether tokens must (True) or must not
    (False) overflow their expert's capacity."""
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf,
                       router_blocked_cumsum=blocked)
    xt, router = _route_inputs(t, d, e, seed=t + e, bias=bias)
    jw, jidx, jpos, jkeep, jcap, jaux = jmoe._route(
        jcfg, jnp.asarray(xt), jnp.asarray(router))
    w, idx, pos, keep, cap, aux = tmoe._route(
        tcfg, torch.from_numpy(xt), torch.from_numpy(router))
    assert cap == jcap == min(int(max(k * t // e * cf, 4)), t)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert w.dtype == torch.float32
    _close(w, jw, 1e-6, "weights")
    _close(aux, jaux, 1e-6, "aux")
    if drops is not None:
        assert bool((~keep).any()) == drops
    # token-major priority: an expert's kept slots go to its earliest
    # (token, choice) rows, in order
    for ex in range(e):
        rows = np.flatnonzero(idx.numpy().ravel() == ex)
        np.testing.assert_array_equal(pos.numpy().ravel()[rows],
                                      np.arange(rows.size))


def test_router_topk_equals_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(50, 64).astype(np.float32) * 2
    for renorm in (True, False):
        jw, jidx = jmoe.router_topk(jnp.asarray(logits), 8, renorm)
        w, idx = tmoe.router_topk(torch.from_numpy(logits), 8, renorm)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(w, jw, 1e-6, f"router_topk renormalize={renorm}")


@pytest.mark.parametrize("n,e", [(1, 4), (7, 3), (2048, 8), (2400, 64),
                                 (4099, 5), (16384, 64)])
def test_blocked_cumsum_equals_flat_and_jax(n, e):
    rng = np.random.RandomState(n)
    flat = np.eye(e, dtype=np.int32)[rng.randint(0, e, n)]
    t = torch.from_numpy(flat)
    got = {b: tmoe._exclusive_cumsum_rows(
        dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                            router_blocked_cumsum=b), t) for b in (False,
                                                                   True)}
    want = jmoe._exclusive_cumsum_rows(
        dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                            router_blocked_cumsum=True), jnp.asarray(flat))
    assert got[True].dtype == torch.int32
    assert torch.equal(got[True], got[False])
    np.testing.assert_array_equal(got[True].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[False].numpy(),
                                  np.cumsum(flat, 0) - flat)


def test_load_balance_loss_equals_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(96, 16).astype(np.float32)
    idx = np.argsort(-logits, -1)[:, :4].astype(np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 16)
    got = tmoe.load_balance_loss(torch.from_numpy(logits),
                                 torch.from_numpy(idx).long(), 16)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-6, "load_balance_loss")


def _moe_params(arch, dtype, seed=0):
    """One MoE layer's weights: JAX's ``init_moe_layer``, carried across
    with their dtypes (bf16 values are exact in float32)."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp = jparams.init_moe_layer(jcfg, KeyGen(jax.random.PRNGKey(seed)))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, str(v.dtype))) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek_v2_236b"])
def test_moe_ffn_gather_matches_jax_and_the_einsum_oracle(arch, dtype):
    """At the default capacity 1.25 (some tokens dropped), olmoe's routed
    experts and deepseek's with its shared expert, against JAX's at 1e-5
    in float32 and 3e-2 in bfloat16, and against the port's one-hot
    oracle at the same tolerances (in bf16 the oracle's dispatch products
    round on their own)."""
    jcfg, tcfg, jp, tp = _moe_params(arch, dtype)
    # pull the tokens towards expert 0, past its capacity (as in
    # _route_inputs)
    jp["router"] = jp["router"].at[0, 0].set(3.0)
    tp["router"][0, 0] = 3.0
    rng = np.random.RandomState(4)
    x32 = rng.randn(2, 32, jcfg.d_model).astype(np.float32)
    x32[..., 0] = 1.0
    jx = jnp.asarray(x32, jcfg.param_dtype)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(tcfg.param_dtype)
    jy, jaux = jmoe.moe_ffn_gather(jcfg, jp, jx)
    y, aux = tmoe.moe_ffn_gather(tcfg, tp, tx)
    oracle, oaux = tmoe.moe_ffn_einsum(tcfg, tp, tx)
    assert y.dtype == tcfg.param_dtype and y.shape == tx.shape
    _close(aux, jaux, 1e-6, "aux")
    assert float(oaux) == float(aux)
    keep = tmoe._route(tcfg, tx.reshape(-1, jcfg.d_model), tp["router"])[3]
    assert bool((~keep).any())                  # the capacity dropped some
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close(y, jy, tol, "moe_ffn")
    _close(y, oracle.float(), tol, "einsum oracle")
    tcfg_e = dataclasses.replace(tcfg, moe_impl="einsum")
    assert torch.equal(tmoe.moe_ffn(tcfg_e, tp, tx)[0], oracle)
    assert torch.equal(tmoe.moe_ffn(tcfg, tp, tx)[0], y)


@pytest.mark.parametrize("t,e,k", [(200, 64, 8), (96, 160, 6), (64, 4, 2)])
def test_combine_equals_xla_scatter_add_bit_for_bit(t, e, k):
    """The combine on the same bf16 slot outputs as JAX's scatter-add
    (``moe.py:173``), at the capacity 1.25 (some dropped): equal bit for
    bit. The outputs span 2^-6 to 2^6, so that the order of the adds shows:
    adding in the reverse order of the expert ids differs."""
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=1.25)
    xt, router = _route_inputs(t, 16, e, seed=t, bias=3.0)
    w, idx, pos, keep, cap, _ = tmoe._route(tcfg, torch.from_numpy(xt),
                                            torch.from_numpy(router))
    d = 32
    rng = np.random.RandomState(e)
    ye = (rng.randn(e * cap, d) * 2.0 ** rng.randint(-6, 7, (e * cap, 1))
          ).astype(np.float32)
    jye = jnp.asarray(ye, jnp.bfloat16)
    tye = torch.from_numpy(np.asarray(jye, np.float32)).bfloat16()
    # JAX's table and scatter-add, as moe_ffn_gather builds them
    jidx, jpos, jkeep = (jnp.asarray(a.numpy()).reshape(-1)
                         for a in (idx, pos, keep))
    tok = jnp.repeat(jnp.arange(t), k)
    e_idx = jnp.where(jkeep, jidx, e)
    c_idx = jnp.where(jkeep, jpos, 0)
    table = jnp.zeros((e + 1, cap), jnp.int32).at[e_idx, c_idx].set(
        tok, mode="drop")[:e]
    filled = jnp.zeros((e + 1, cap), jnp.bool_).at[e_idx, c_idx].set(
        True, mode="drop")[:e]
    jye = jye * filled.reshape(-1, 1).astype(jye.dtype)   # unfilled: 0
    want = np.asarray(jnp.zeros((t, d), jnp.bfloat16).at[
        table.reshape(-1)].add(jye), np.float32)
    slot = torch.where(keep, idx * cap + pos, e * cap)
    rows = torch.cat([tye * torch.from_numpy(np.asarray(filled).reshape(
        -1, 1)).bfloat16(), tye.new_zeros((1, d))])
    got = tmoe._combine(rows, slot, idx)
    assert bool((~keep).any())
    np.testing.assert_array_equal(got.float().numpy(), want)
    if k > 2:
        rev = tmoe._combine(rows, slot, -idx)       # reverse expert order
        assert not np.array_equal(rev.float().numpy(), want)


def test_combine_order_is_fixed(monkeypatch):
    """The combine adds each token's slot outputs in the order of their
    expert ids, whatever the order of its top-k choices: reversing every
    token's choices leaves the bfloat16 output bit for bit the same (the
    positions in the experts' buffers do not depend on that order
    either)."""
    jcfg, tcfg, jp, tp = _moe_params(ARCH, "bfloat16", seed=3)
    rng = np.random.RandomState(7)
    tx = torch.from_numpy(rng.randn(2, 48, jcfg.d_model).astype(np.float32)
                          * 4).bfloat16()
    y = tmoe.moe_ffn_gather(tcfg, tp, tx)[0]
    topk = tmoe.router_topk

    def reversed_topk(logits, k, renormalize=True):
        w, idx = topk(logits, k, renormalize)
        return w.flip(-1), idx.flip(-1)

    monkeypatch.setattr(tmoe, "router_topk", reversed_topk)
    assert torch.equal(tmoe.moe_ffn_gather(tcfg, tp, tx)[0], y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype, monkeypatch):
    """In bfloat16 olmoe's router inputs come out of the same bf16 roundings
    in both packages: the probabilities differed by at most 1.2e-7 (one
    float32 rounding) and no choice flipped at 1, 2 and 8 CPU threads."""
    routing = FollowJaxAtNearTies(monkeypatch, tol=1e-5, max_flips=0) \
        if dtype == "bfloat16" else None
    check_forward_prefill_decode(ARCH, dtype)
    if routing is not None:
        routing.done()
