"""Plain float32 reference of the ``ssm`` family: RWKV-6 "Finch" as the port
serves it (token shift with data-dependent low-rank mixes, the WKV
recurrence with a data-dependent decay and a bonus, per-head group norm
and a SiLU gate, a squared-ReLU channel mix; the configuration's
``departures`` list where that differs from the published model). It
imports nothing of the program.

Each request is independent of the others, so the reference runs the
requests it is given, each as one sequence: its prompt and its served
tokens fed back, from a zero state, layer by layer. The WKV recurrence

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

runs in chunks: inside a chunk the decay between two tokens is taken as
one exponential of the difference of their cumulative log-decays (never
above 1), across chunks through the state, all in float32.

``precision="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3, weights with a scale a column, activations with a scale a
row.
"""

from __future__ import annotations

import torch

from .common import F32, linear, rms_norm

CHUNK = 64


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """r, k, v, logw (B, H, L, D) float32, u (H, D): o (B, H, L, D) from a
    zero state."""
    b, h, L, d = r.shape
    state = torch.zeros((b, h, d, d), dtype=F32, device=r.device)
    out = torch.empty_like(v)
    bonus = torch.sum(r * u[None, :, None, :] * k, dim=-1, keepdim=True) * v
    for a in range(0, L, chunk):
        e = min(L, a + chunk)
        rc, kc, vc, lw = r[:, :, a:e], k[:, :, a:e], v[:, :, a:e], \
            logw[:, :, a:e]
        incl = torch.cumsum(lw, dim=2)            # log-decay through t
        excl = incl - lw                          # ... up to t - 1
        c = e - a
        # decay from s + 1 to t - 1 between key s and query t > s
        diff = excl[:, :, :, None, :] - incl[:, :, None, :, :]
        later = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                      device=r.device), diagonal=-1)
        diff = torch.where(later[None, None, :, :, None], diff, -torch.inf)
        att = torch.einsum("bhtd,bhsd,bhtsd->bhts", rc, kc, torch.exp(diff))
        o = torch.matmul(att, vc)
        o = o + torch.matmul(rc * torch.exp(excl), state)
        out[:, :, a:e] = o
        total = incl[:, :, -1:]
        state = state * torch.exp(total[:, :, 0, :, None]) + torch.matmul(
            (kc * torch.exp(total - incl)).transpose(-1, -2), vc)
    return out + bonus


def _shift(x):
    """The previous token's row, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _time_mix(x, p, m, r, precision):
    b, L, d = x.shape
    h = m["n_heads"]
    delta = _shift(x) - x

    def mixed(name):
        mix = p[f"mix_{name}"].to(F32)
        boost = torch.tanh(linear(x + delta * mix, p["mix_A"], precision))
        return x + delta * (mix + linear(boost, p[f"mix_B_{name}"],
                                         precision))

    def heads(t):
        return t.reshape(b, L, h, -1).transpose(1, 2)

    rr = heads(linear(mixed("r"), p["wr"], precision))
    kk = heads(linear(mixed("k"), p["wk"], precision))
    vv = heads(linear(mixed("v"), p["wv"], precision))
    g = torch.nn.functional.silu(linear(mixed("g"), p["wg"], precision))
    xw = linear(torch.tanh(linear(mixed("w"), p["decay_A"], precision)),
                p["decay_B"], precision)
    logw = torch.clamp(-torch.exp(p["decay_base"].to(F32) + xw),
                       r["log_decay_min"], r["log_decay_max"])
    o = wkv(rr, kk, vv, heads(logw), p["u"].to(F32))
    o = o.transpose(1, 2)                                # (B, L, H, D)
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = ((o - mu) * torch.rsqrt(var + r["group_norm_eps"])).reshape(b, L, d)
    o = o * p["ln_x"].to(F32)
    return linear(o * g, p["wo"], precision)


def _channel_mix(x, p, precision):
    delta = _shift(x) - x
    xk = x + delta * p["cmix_k"].to(F32)
    xr = x + delta * p["cmix_r"].to(F32)
    kk = torch.square(torch.relu(linear(xk, p["ck"], precision)))
    return torch.sigmoid(linear(xr, p["cr"], precision)) \
        * linear(kk, p["cv"], precision)


def served_logits(config: dict, params: dict, prompt: torch.Tensor,
                  fed: torch.Tensor, precision: str = "float32"
                  ) -> torch.Tensor:
    """Logits (B, n, V) float32 at the n positions that give the served
    tokens: the last prompt position and each fed token's. ``prompt``
    (B, S) and ``fed`` (B, n - 1) token ids, the served tokens but the
    last."""
    m, r = config["model"], config["reference"]
    eps = r["norm_eps"]
    tokens = torch.cat([prompt, fed], dim=1).long()
    s = prompt.shape[1]
    x = rms_norm(params["embed"][tokens].to(F32), params["ln0"], eps)
    blocks = params["blocks"]
    for layer in range(m["n_layers"]):
        p = {key: leaf[layer] for key, leaf in blocks.items()}
        x = x + _time_mix(rms_norm(x, p["ln1"], eps), p, m, r, precision)
        x = x + _channel_mix(rms_norm(x, p["ln2"], eps), p, precision)
    hn = rms_norm(x[:, s - 1:], params["final_norm"], eps)
    return linear(hn, params["lm_head"], precision)
