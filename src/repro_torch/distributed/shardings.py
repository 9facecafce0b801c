"""Sharding rules: DP over ("pod", "data"), TP/EP/SP over "model" (the
counterpart of ``repro/distributed/shardings.py``).

The rules are data, as in the reference: a spec ``P`` names, for each
dimension of a tensor, the mesh dimension it is split over ("data",
"model", a tuple of them, or None). They are name and rank based over the
parameter tree (see ``models/params.py`` for the layout), and a spec tree
has the structure of the tree it describes (its leaves, in
``repro_torch.tree.tree_leaves`` order, are specs). The same rules serve
both production meshes, ("data", "model") and ("pod", "data", "model"),
because DP axes are resolved against the mesh at hand. Only
:func:`to_placements` speaks DTensor: it turns a spec into one
``Shard(i)`` / ``Replicate()`` placement a mesh dimension.

KV-cache policy (``kv_shard_mode``): shard the kv-head axis over "model"
when it divides evenly; otherwise shard the sequence (SP decode). That is
what lets qwen2 (kv = 2) and MLA (a headless latent cache) split over a
16-wide model axis.

``cfg.moe_shard_hints`` has no counterpart here: on one device the port's
MoE dispatch ignores it (``models/moe.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

MODEL = "model"


class P(tuple):
    """A partition spec: one entry a tensor dimension, each None, a mesh
    dimension's name or a tuple of names. ``P()`` replicates. It is a
    tuple, so it compares equal, entry for entry, to JAX's
    ``PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh.mesh_dim_names if n in ("pod", "data"))


def _tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (the parameter trees),
    ``path`` the keys from the root."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


# --------------------------------------------------------------- parameters
#: name -> (rule) where rule maps trailing (non-layer) dims.
#: "col": shard last dim; "row": shard second-to-last dim; "rep": replicate;
#: "expert": shard the expert dim (dim -3 of an (..., E, d, f) stack);
#: "vocab_in": (V, d) shard dim -2; "vocab_out": (d, V) shard dim -1.
_RULES: Dict[str, str] = {
    "embed": "vocab_in",
    "lm_head": "vocab_out",
    "mm_proj": "rep",
    # attention
    "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    "bq": "bias_col", "bk": "bias_col", "bv": "bias_col",
    "xwq": "col", "xwk": "col", "xwv": "col", "xwo": "row",
    # mlp (rank-3 stacked) vs moe experts (rank-4 stacked) share names
    "wg": "col_or_expert", "wu": "col_or_expert", "wd": "row_or_expert",
    "sg": "col", "su": "col", "sd": "row",
    "router": "rep",
    # MLA
    "q_a": "rep", "q_b": "col", "kv_a": "rep", "kv_b": "col", "o": "row",
    # rwkv6
    "wr": "col", "ck": "col", "cv": "row", "cr": "col",
    "u": "heads",
    # mamba2
    "in_zx": "col", "in_bcdt": "rep", "conv_w": "rep",
    "out_proj": "row", "out_norm": "rep",
}


def _spec_for(path, leaf, n_layer_dims: int, msize: int, dsize: int,
              fsdp: bool, ep_data: bool = False) -> P:
    name = path[-1]
    rule = _RULES.get(name, "rep")
    nd = leaf.ndim
    lead = [None] * n_layer_dims

    def tail(spec_tail):
        pad = [None] * (nd - n_layer_dims - len(spec_tail))
        # divisibility guard: a tensor must split evenly
        spec = lead + pad + list(spec_tail)
        for i, ax in enumerate(spec):
            if ax == MODEL and leaf.shape[i] % msize != 0:
                spec[i] = None
            if ax == "data" and leaf.shape[i] % dsize != 0:
                spec[i] = None
        if fsdp and nd - n_layer_dims >= 2:
            # FSDP (ZeRO-3 style): also shard the largest unsharded dim
            # over "data"; weights are all-gathered a layer at a time,
            # optimizer state stays fully sharded.
            free = [i for i, ax in enumerate(spec)
                    if ax is None and i >= n_layer_dims
                    and leaf.shape[i] % dsize == 0]
            if free:
                best = max(free, key=lambda i: leaf.shape[i])
                spec[best] = "data"
        return P(*spec)

    if rule == "rep" or nd <= n_layer_dims:
        return P()
    if rule == "vocab_in":
        if leaf.shape[0] % msize:
            return tail([None, MODEL])   # uneven vocab: shard d instead
        return tail([MODEL, None])
    if rule == "vocab_out":
        if leaf.shape[1] % msize:
            return tail([MODEL, None])
        return tail([None, MODEL])
    if rule == "bias_col":
        return tail([MODEL])
    if rule == "col":
        return tail([None, MODEL])
    if rule == "row":
        return tail([MODEL, None])
    if rule == "heads":
        return tail([MODEL, None])
    if rule == "col_or_expert":
        if nd - n_layer_dims >= 3:               # (E, d, f) expert stack
            if ep_data:
                # full expert partition: E over (model x data) would not
                # divide; E -> data and the weight's d/f dim -> model, so no
                # device holds (or gathers) more than 1/256 of the experts
                return tail(["data", MODEL, None])
            return tail([MODEL, None, None])
        return tail([None, MODEL])
    if rule == "row_or_expert":
        if nd - n_layer_dims >= 3:
            if ep_data:
                return tail(["data", MODEL, None])
            return tail([MODEL, None, None])
        return tail([MODEL, None])
    raise ValueError(rule)


def _layer_dims_of(path, cfg) -> int:
    """How many leading stacked-layer dims this leaf has."""
    top = path[0]
    if top in ("embed", "lm_head", "final_norm", "enc_final_norm", "ln0",
               "mm_proj"):
        return 0
    if top == "shared_attn":
        return 0
    if top == "blocks" and cfg.family == "hybrid":
        return 2                                  # (period, layer_in_period)
    if top == "blocks" and cfg.layer_pattern == "local_global":
        return 1                                  # (pair,) + local/global key
    return 1


def param_specs(cfg, params_shape, mesh=None) -> Any:
    """The spec tree of ``params_shape`` (a parameter tree, e.g. on the
    meta device from ``launch.steps.params_struct``). Without a mesh the
    production sizes, 16 on "data" and on "model"."""
    msize, dsize = 16, 16
    if mesh is not None:
        sizes = _mesh_sizes(mesh)
        msize = sizes.get(MODEL, 1)
        dsize = sizes.get("data", 1)

    def fn(path, leaf):
        return _spec_for(path, leaf, _layer_dims_of(path, cfg), msize,
                         dsize, cfg.fsdp, getattr(cfg, "moe_ep_data",
                                                  False))
    return _tree_map_with_path(fn, params_shape)


def opt_state_specs(cfg, opt_state_shape, pspecs) -> Any:
    """AdamW moments mirror the param shardings; step is replicated."""
    from ..optim import AdamWState
    return AdamWState(step=P(), mu=pspecs, nu=pspecs)


# -------------------------------------------------------------------- batch
def batch_specs(cfg, mesh, kind: str) -> Dict[str, P]:
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    specs: Dict[str, P] = {}
    if cfg.family == "encdec":
        specs["frames"] = P(dp, None, None)
        specs["dec_tokens"] = P(dp, None)
        if kind == "train":
            specs["labels"] = P(dp, None)
        return specs
    specs["tokens"] = P(dp, None)
    if kind == "train":
        specs["labels"] = P(dp, None)
    if cfg.frontend == "vision":
        specs["vision_embeds"] = P(dp, None, None)
    return specs


def kv_shard_mode(cfg, mesh) -> str:
    msize = _mesh_sizes(mesh).get(MODEL, 1)
    if cfg.n_kv_heads % msize == 0:
        return "heads"
    return "seq"


def _dp_or_none(mesh, batch: int) -> Optional[Any]:
    """Batch axis spec: shard over DP only if it divides evenly."""
    dp = dp_axes(mesh)
    sizes = _mesh_sizes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    if batch % dp_total == 0 and batch >= dp_total:
        return dp if len(dp) > 1 else dp[0]
    return None


def cache_specs(cfg, mesh, cache_shape, batch: int) -> Any:
    """Spec tree for a decode cache tree (explicit per family)."""
    mode = kv_shard_mode(cfg, mesh)
    dp = _dp_or_none(mesh, batch)

    def kv_spec(leaf):
        nd = leaf.ndim                     # (..., B, Hkv, Smax, hd)
        lead = [None] * (nd - 4)
        if mode == "heads":
            return P(*lead, dp, MODEL, None, None)
        return P(*lead, dp, None, MODEL, None)

    fam = cfg.family
    if fam in ("dense",) or (fam == "moe" and not cfg.mla):
        return {k: kv_spec(v) for k, v in cache_shape.items()}
    if fam == "moe" and cfg.mla:
        # (L, B, Smax, r): shard the sequence (SP decode for MLA)
        return {k: P(None, dp, MODEL, None) for k in cache_shape}
    if fam == "ssm":
        return (P(None, dp, None),                    # att_xprev (L,B,d)
                P(None, dp, MODEL, None, None),       # state (L,B,H,dk,dv)
                P(None, dp, None))                    # cmix_xprev
    if fam == "hybrid":
        def mamba_spec(pair, n_lead):
            lead = [None] * n_lead
            return (P(*lead, dp, MODEL, None, None),  # (..,B,H,pd,n)
                    P(*lead, dp, None, MODEL))        # (..,B,k-1,convdim)
        return {
            "mamba": mamba_spec(cache_shape["mamba"], 2),
            "k": kv_spec(cache_shape["k"]),
            "v": kv_spec(cache_shape["v"]),
            "tail": (mamba_spec(cache_shape["tail"], 1)
                     if cache_shape.get("tail") is not None else None),
        }
    if fam == "encdec":
        return {k: kv_spec(v) for k, v in cache_shape.items()}
    raise ValueError(fam)


# ---------------------------------------------------------------- placements
def to_placements(spec: P, mesh) -> List[Any]:
    """DTensor placements of a tensor with ``spec`` on ``mesh``: one for
    each mesh dimension, in the mesh's order, ``Shard(i)`` where the spec
    splits tensor dim ``i`` over it, else ``Replicate()``. Raises
    ``ValueError`` if the spec names a mesh dimension twice or one the mesh
    does not have."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is None:
                continue
            if name not in names:
                raise ValueError(f"spec {spec} names {name!r}, the mesh has "
                                 f"{names}")
            if name in dim_of:
                raise ValueError(f"spec {spec} names {name!r} twice")
            dim_of[name] = i
    return [Shard(dim_of[n]) if n in dim_of else Replicate() for n in names]

