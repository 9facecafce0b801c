"""Plain float32 reference of the ``moe`` family: olmoe-1b-7b as the port
serves it (RMSNorm, RoPE on half-split heads, causal multi-head attention,
a top-k router over experts with capacity, SwiGLU experts, an untied LM
head; the configuration's ``departures`` list where that differs from the
published model). It imports nothing of the program.

Serving groups tokens for the experts' capacity in two ways, and the
reference keeps both: the prefill routes every prompt token of a round
together (token-major: request 0's tokens first), each decode step routes
that step's token of every request together. The reference runs the
prompt and the served tokens fed back as one sequence a request, layer by
layer over the whole round, with the prompt positions as one routing group
and each decode position as another; attention is causal over the whole
sequence, as the cache makes it.

``precision="fp8"`` is the control: every matrix product's operands (the
router's excepted) rounded to float8 e4m3, weights with a scale a column,
activations with a scale a row.
"""

from __future__ import annotations

import math

import torch

from .common import F32, linear, rms_norm, rope


def _attention(q, k, v, block: int = 1024):
    """Causal attention, float32, one request and query block at a time:
    q, k, v (B, H, L, D) -> (B, H, L, D)."""
    b, h, L, d = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(L, device=q.device)
    for i in range(b):
        for a in range(0, L, block):
            e = min(L, a + block)
            s = torch.matmul(q[i, :, a:e], k[i, :, :e].transpose(-1, -2))
            s = s * scale
            keep = pos[None, :e] <= pos[a:e, None]
            s = torch.where(keep, s, -math.inf)
            out[i, :, a:e] = torch.matmul(torch.softmax(s, dim=-1),
                                          v[i, :, :e])
    return out


def _route(x, router, k, capacity_factor):
    """Top-k of the softmax, renormalised; each (token, choice) kept when
    fewer than the capacity of earlier tokens chose the same expert."""
    t, e = x.shape[0], router.shape[1]
    probs = torch.softmax(torch.matmul(x, router), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    capacity = min(int(max(k * t // e * capacity_factor, 4)), t)
    chose = torch.zeros((t, e), dtype=torch.int64, device=x.device)
    chose.scatter_(1, idx, 1)
    before = torch.cumsum(chose, dim=0) - chose
    keep = torch.gather(before, 1, idx) < capacity
    return w * keep, idx


def _experts(x, p, k, capacity_factor, precision):
    """The routed SwiGLU experts for one routing group x (T, d): the kept
    (token, choice) pairs sorted by expert, one expert's tokens at a
    time."""
    w, idx = _route(x, p["router"].to(F32), k, capacity_factor)
    kept = torch.nonzero(w.reshape(-1) > 0, as_tuple=True)[0]
    experts = idx.reshape(-1)[kept]
    order = kept[torch.argsort(experts, stable=True)]
    counts = torch.bincount(experts, minlength=p["wg"].shape[0]).tolist()
    out = torch.zeros_like(x)
    at = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        pairs = order[at:at + n]
        at += n
        tok = pairs // k
        xe = x[tok]
        gate = linear(xe, p["wg"][e], precision)
        hid = torch.nn.functional.silu(gate) * linear(xe, p["wu"][e],
                                                      precision)
        ye = linear(hid, p["wd"][e], precision)
        out.index_add_(0, tok, ye * w.reshape(-1)[pairs, None])
    return out


def _moe(h, p, prompt_len, k, capacity_factor, precision):
    """The prompt's positions as one group, each later position as one."""
    b, L, d = h.shape
    out = torch.empty_like(h)
    groups = [slice(0, prompt_len)] + [slice(j, j + 1)
                                       for j in range(prompt_len, L)]
    for g in groups:
        xg = h[:, g].reshape(-1, d)
        out[:, g] = _experts(xg, p, k, capacity_factor,
                             precision).reshape(b, -1, d)
    return out


def served_logits(config: dict, params: dict, prompt: torch.Tensor,
                  fed: torch.Tensor, precision: str = "float32"
                  ) -> torch.Tensor:
    """Logits (B, n, V) float32 at the n positions that give the served
    tokens: the last prompt position and each fed token's. ``prompt``
    (B, S) and ``fed`` (B, n - 1) token ids, the served tokens but the
    last."""
    m, r = config["model"], config["reference"]
    h_, hkv, eps = m["n_heads"], m["n_kv_heads"], r["norm_eps"]
    tokens = torch.cat([prompt, fed], dim=1).long()
    b, L = tokens.shape
    s = prompt.shape[1]
    x = params["embed"][tokens].to(F32)
    pos = torch.arange(L, device=x.device)
    blocks = params["blocks"]
    for layer in range(m["n_layers"]):
        p = {key: leaf[layer] for key, leaf in blocks.items()}
        hn = rms_norm(x, p["ln1"], eps)

        def heads(w, n):
            t = linear(hn, w, precision).reshape(b, L, n, -1)\
                .transpose(1, 2)
            return t.repeat_interleave(h_ // n, dim=1)

        q = rope(heads(p["wq"], h_), pos, m["rope_theta"])
        kk = rope(heads(p["wk"], hkv), pos, m["rope_theta"])
        o = _attention(q, kk, heads(p["wv"], hkv))
        del q, kk
        o = o.transpose(1, 2).reshape(b, L, -1)
        x = x + linear(o, p["wo"], precision)
        hn = rms_norm(x, p["ln2"], eps)
        x = x + _moe(hn, p, s, m["top_k"], m["capacity_factor"], precision)
    hn = rms_norm(x[:, s - 1:], params["final_norm"], eps)
    return linear(hn, params["lm_head"], precision)
