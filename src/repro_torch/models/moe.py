"""Mixture-of-Experts of the reference's ``repro.models.moe`` on PyTorch
tensors: the router (softmax, top-k, renormalise), ``moe_dense`` (every
expert computed for every token, gated combine), ``moe_ep`` (expert
parallelism over ranks) with its plain version ``moe_ep_ref``, and
``moe_apply`` (routed experts plus the shared experts).

``moe_apply`` takes the expert-parallel path exactly when the reference
would: the context asks for it (``ctx.ep``) with a mesh whose ``ep_axis``
divides the expert count.  A rank of a group of processes
(``ctx.ep_group`` set, ``serving.tp.run_grid``) runs ``moe_ep`` on its
shards; one process holding every shard (the dry run's ``meta`` pass) runs
``moe_ep_ref``, which computes every shard's ``_ep_local`` in one process.
Without a mesh it takes the dense branch, as the reference does.

``moe_dense`` computes the expert products as batched matrix products
(``torch.matmul``) over the stored (E, d, F) weights, which are read in
place, never permuted or copied.

Parameters (the reference's layout): ``router`` (d, E); ``w_gate`` /
``w_up`` (E, d, F); ``w_down`` (E, F, d); with shared experts
``shared_gate`` / ``shared_up`` (d, n_shared * F) and ``shared_down``
(n_shared * F, d).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import cost
from repro_torch.models.layers import silu
from repro_torch.models.partition import NULL_CTX, best_axes, entry_axes


def _route(x2, router, top_k: int):
    """x2: (T, d) -> (topv, topi) each (T, k), renormalised.

    The router runs in f32 (exact products of the stored values, f32 sums),
    as the reference's ``preferred_element_type=float32``.  Top-k takes the
    lower expert index first among equal probabilities, as ``lax.top_k``
    does: a stable descending sort, then its first k."""
    logits = x2.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return topv, topi


def moe_dense(x, p, cfg):
    """x: (B, S, d).  Every expert on every token; the k chosen experts'
    outputs combined in f32 with the router's weights, then cast back.

    The combine adds the k weighted outputs one after another in
    elementwise ops, so a token's result does not depend on the other
    tokens of the call.  The reference sums all E gated outputs, the
    unchosen ones with weight 0; the two differ at f32 rounding only."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    T = x2.shape[0]
    topv, topi = _route(x2, p["router"], cfg.top_k)
    xe = x2[None]                                       # (1, T, d)
    g = torch.matmul(xe, p["w_gate"])                   # (E, T, F)
    u = torch.matmul(xe, p["w_up"])
    y_all = torch.matmul(silu(g) * u, p["w_down"])      # (E, T, d)
    tok = torch.arange(T, device=x.device)
    comb = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        comb = comb + y_all[topi[:, j], tok].float() * topv[:, j:j + 1]
    return comb.to(x.dtype).reshape(B, S, d)


# ---------------------------------------------------------------------------
# Expert parallelism (the reference's moe_ep / _ep_local)
# ---------------------------------------------------------------------------
def gather_mode(cfg, ctx, fsdp: int) -> str:
    """The reference's choice for expert weights of shape (E, d, F) over an
    FSDP axis of ``fsdp`` ranks:

    'tokens'  - decode under decode TP: the weights stay RESIDENT with d_ff
                sharded over the FSDP axis; the (tiny) token batch is
                all-gathered across it and the partial expert outputs are
                summed (psum) instead;
    'weights' - train/prefill: weights storage-sharded on d_model over the
                FSDP axis, all-gathered at use;
    'none'    - d_model does not divide: weights unsharded on d."""
    if ctx.phase == "decode" and ctx.decode_tp \
            and cfg.d_ff_expert % fsdp == 0:
        return "tokens"
    if cfg.d_model % fsdp == 0:
        return "weights"
    return "none"


def ep_weight_specs(mode: str, ep_axis: str = "model",
                    fsdp_axis: str = "data") -> dict:
    """Specs of w_gate / w_up (E, d, F) and w_down (E, F, d) a rank holds
    in ``mode``: experts over ``ep_axis``, and d_model ('weights') or d_ff
    ('tokens') over ``fsdp_axis``."""
    if mode == "tokens":
        w, wd = (ep_axis, None, fsdp_axis), (ep_axis, fsdp_axis, None)
    elif mode == "weights":
        w, wd = (ep_axis, fsdp_axis, None), (ep_axis, None, fsdp_axis)
    else:
        w = wd = (ep_axis, None, None)
    return {"w_gate": w, "w_up": w, "w_down": wd}


def capacity(cfg, T: int) -> int:
    """Slots per expert for T routed tokens: ceil(T * k / E * cf)."""
    return max(1, math.ceil(T * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor))


def _slots(topi, E: int, C: int):
    """Sorted-rank slotting of the (..., T, k) expert choices: each choice's
    rank among the choices of its expert in token order; kept when below
    C; its slot e * C + rank (clipped into range).  Returns (slot, keep)
    each (..., T * k)."""
    lead = topi.shape[:-2]
    n = topi.shape[-2] * topi.shape[-1]
    flat_e = topi.reshape(*lead, n)
    counts = torch.zeros(*lead, E, dtype=torch.long, device=topi.device)
    counts.scatter_add_(-1, flat_e, torch.ones_like(flat_e))
    offs = torch.cumsum(counts, -1) - counts
    order = torch.argsort(flat_e, dim=-1, stable=True)
    ar = torch.arange(n, device=topi.device).expand_as(flat_e)
    rank_sorted = ar - offs.gather(-1, flat_e.gather(-1, order))
    rank = torch.zeros_like(flat_e).scatter(-1, order, rank_sorted)
    keep = rank < C
    slot = (flat_e * C + rank).clamp(0, E * C - 1)
    return slot, keep


def _dispatch(x2, topi, E: int, C: int, k: int):
    """(send (..., E * C, d), slot, keep): each kept choice's token row in
    its slot, zeros elsewhere (a dropped choice adds a zero row)."""
    slot, keep = _slots(topi, E, C)
    T, d = x2.shape[-2:]
    tok = torch.arange(T * k, device=x2.device) // k
    rows = torch.where(keep[..., None], x2[..., tok, :], 0)
    send = x2.new_zeros(*x2.shape[:-2], E * C, d)
    send.scatter_add_(-2, slot[..., None].expand_as(rows), rows)
    return send, slot, keep


def _combine(ret, slot, keep, topv, T: int, k: int):
    """Each token's k expert outputs from its slots, weighted by the
    router (0 where dropped) and summed over k."""
    d = ret.shape[-1]
    got = ret.gather(-2, slot[..., None].expand(*slot.shape, d))
    w = (topv.reshape(*topv.shape[:-2], T * k) * keep).to(ret.dtype)
    return (got * w[..., None]).reshape(*ret.shape[:-2], T, k, d).sum(-2)


def _expert_ffn(tokens, wg, wu, wd):
    """tokens: (E, C, d); weights (E, d, F) / (E, F, d)."""
    g = torch.matmul(tokens, wg)
    u = torch.matmul(tokens, wu)
    return torch.matmul(silu(g) * u, wd)


def _ep_local(x_local, router, wg, wu, wd, *, cfg, ep, fsdp, mode,
              stats=None):
    """One rank's expert-parallel MoE (the reference's ``_ep_local``).
    x_local: (B_l, S_l, d), the rank's shard; ``ep`` / ``fsdp``: its
    collective handles along the EP and FSDP axes; the weights the rank's
    shards in ``mode`` (``ep_weight_specs``).  Tokens are routed, slotted
    by sorted rank up to the capacity, sent owner-major to the rank holding
    their experts (all-to-all), run through the experts, returned (the
    second all-to-all) and combined."""
    m = ep.size
    E, k = cfg.num_experts, cfg.top_k
    E_l = E // m
    B_l, S_l, d = x_local.shape
    T_own = B_l * S_l
    if mode == "weights":
        wg = fsdp.all_gather(wg, dim=1)
        wu = fsdp.all_gather(wu, dim=1)
        wd = fsdp.all_gather(wd, dim=2)
    x2 = x_local.reshape(T_own, d)
    if mode == "tokens":
        x2 = fsdp.all_gather(x2, dim=0)
    T = x2.shape[0]
    C = capacity(cfg, T)
    topv, topi = _route(x2, router, k)
    send, slot, keep = _dispatch(x2, topi, E, C, k)
    if stats is not None:
        stats["kept"] = stats.get("kept", 0) + keep.sum()
    recv = ep.all_to_all(send.reshape(m, E_l * C, d))
    # recv[j]: the tokens rank j of the EP group routed to my experts
    toks = recv.reshape(m, E_l, C, d).transpose(0, 1).reshape(E_l, m * C, d)
    y = _expert_ffn(toks, wg, wu, wd)                     # (E_l, m*C, d)
    if mode == "tokens":
        y = fsdp.all_reduce(y)      # partial over the d_ff shard
    back = y.reshape(E_l, m, C, d).transpose(0, 1).reshape(m, E_l * C, d)
    ret = ep.all_to_all(back).reshape(E * C, d)
    out = _combine(ret, slot, keep, topv, T, k)
    if mode == "tokens":
        out = out[fsdp.rank * T_own:(fsdp.rank + 1) * T_own]
    return out.reshape(B_l, S_l, d).to(x_local.dtype)


def moe_ep(x, p, cfg, ctx, stats=None):
    """Expert-parallel MoE on one rank: x (B_l, S_l, d) its shard of the
    hidden states (batch over ``ctx.batch``, sequence over ``ctx.seq``),
    ``p`` its shards of the expert weights (``ep_weight_specs`` of
    ``gather_mode``; the router replicated).  ``stats``, when given, gains
    "kept": the expert choices that found a slot on this rank (a device
    scalar)."""
    fsdp = ctx.fsdp_group
    mode = gather_mode(cfg, ctx, fsdp.size)
    return _ep_local(x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                     cfg=cfg, ep=ctx.ep_group, fsdp=fsdp, mode=mode,
                     stats=stats)


def x_spec(ctx, shape) -> tuple:
    """The spec of the (B, S, d) hidden states: the batch over the longest
    dividing prefix of ``ctx.batch``, the sequence of ``ctx.seq``."""
    return (best_axes(ctx.mesh, shape[0], ctx.batch),
            best_axes(ctx.mesh, shape[1], ctx.seq), None)


def _block(mesh, coords, entry, n: int):
    """The slice of a dim of size n that ``coords`` holds under a spec
    entry naming ``entry``'s axes (row-major over them)."""
    axes = entry_axes(entry)
    parts, idx = 1, 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
        parts *= mesh.shape[a]
    w = n // parts
    return slice(idx * w, (idx + 1) * w)


def ep_shards(x, p, cfg, ctx, rank: int):
    """Rank ``rank``'s shards for ``moe_ep``, as contiguous tensors: its
    block of the global hidden states x (``x_spec``) and of the expert
    weights (``ep_weight_specs`` of ``gather_mode``; the router whole).
    ``ctx.mesh`` is a ``launch.mesh.Mesh``."""
    mesh = ctx.mesh
    c = mesh.coords(rank)
    spec = x_spec(ctx, x.shape)
    xs = x[_block(mesh, c, spec[0], x.shape[0]),
           _block(mesh, c, spec[1], x.shape[1])].contiguous()
    mode = gather_mode(cfg, ctx, mesh.shape[ctx.fsdp_axis])
    out = {"router": p["router"]}
    for name, wspec in ep_weight_specs(mode, ctx.ep_axis,
                                       ctx.fsdp_axis).items():
        w = p[name]
        out[name] = w[tuple(_block(mesh, c, e, n)
                            for e, n in zip(wspec, w.shape))].contiguous()
    return xs, out


def moe_ep_ref(x, p, cfg, ctx, stats=None):
    """The plain version of ``moe_ep``: every rank of ``ctx.mesh`` (a
    ``launch.mesh.Mesh``) in one process, on the global x (B, S, d) and weights.  Each rank's shard of
    x, its expert-weight block and its ``_ep_local`` math (routing,
    slotting, capacity) are those of ``moe_ep``; the all-to-alls and
    all-gathers are indexing across the ranks' tensors, the decode psum a
    sum in rank order.  The routers and the expert products run per rank,
    at the ranks' shapes (on ``meta``, where nothing runs, batched over the
    ranks).  Returns the (B, S, d) result; ``stats`` gains "kept" summed
    over the ranks.  Each rank's collectives are told to the active cost
    counter (``kernels.cost``), and again for the backward when it runs."""
    mesh = ctx.mesh
    n = mesh.size
    E, k = cfg.num_experts, cfg.top_k
    m, fs = mesh.shape[ctx.ep_axis], mesh.shape[ctx.fsdp_axis]
    E_l = E // m
    mode = gather_mode(cfg, ctx, fs)
    B, S, d = x.shape
    spec = x_spec(ctx, x.shape)
    cs = [mesh.coords(r) for r in range(n)]

    xs = torch.stack([x[_block(mesh, c, spec[0], B),
                        _block(mesh, c, spec[1], S)] for c in cs])
    B_l, S_l = xs.shape[1:3]
    T_own = B_l * S_l
    x2 = xs.reshape(n, T_own, d)
    f_line = torch.tensor([mesh.group(r, ctx.fsdp_axis) for r in range(n)],
                          device=x.device)
    e_line = torch.tensor([mesh.group(r, ctx.ep_axis) for r in range(n)],
                          device=x.device)
    e_idx = torch.tensor([c[ctx.ep_axis] for c in cs], device=x.device)
    f_idx = torch.tensor([c[ctx.fsdp_axis] for c in cs], device=x.device)
    if mode == "tokens":
        x2 = x2[f_line].reshape(n, fs * T_own, d)
    T = x2.shape[1]
    C = capacity(cfg, T)
    per_rank = x.device.type != "meta"
    if per_rank:
        routes = [_route(x2[r], p["router"], k) for r in range(n)]
        topv = torch.stack([v for v, _ in routes])
        topi = torch.stack([i for _, i in routes])
    else:
        topv, topi = _route(x2, p["router"], k)
    send, slot, keep = _dispatch(x2, topi, E, C, k)
    if stats is not None:
        stats["kept"] = stats.get("kept", 0) + keep.sum()
    send = send.reshape(n, m, E_l * C, d)
    recv = send[e_line, e_idx[:, None]]          # (n, m, E_l*C, d)
    toks = recv.reshape(n, m, E_l, C, d).transpose(1, 2) \
        .reshape(n, E_l, m * C, d)
    F = p["w_gate"].shape[2]
    wg = p["w_gate"].reshape(m, E_l, d, F)
    wu = p["w_up"].reshape(m, E_l, d, F)
    wd = p["w_down"].reshape(m, E_l, F, d)
    if mode == "tokens":
        fw = F // fs
        wg = wg.reshape(m, E_l, d, fs, fw)[e_idx, :, :, f_idx]
        wu = wu.reshape(m, E_l, d, fs, fw)[e_idx, :, :, f_idx]
        wd = wd.reshape(m, E_l, fs, fw, d)[e_idx, :, f_idx]
    else:
        wg, wu, wd = wg[e_idx], wu[e_idx], wd[e_idx]
    if per_rank:
        y = torch.stack([_expert_ffn(toks[r], wg[r], wu[r], wd[r])
                         for r in range(n)])
    else:
        y = _expert_ffn(toks, wg, wu, wd)               # (n, E_l, m*C, d)
    if mode == "tokens":
        ys = y[f_line]                                  # (n, fs, ...)
        y = ys[:, 0] + ys[:, 1] if fs > 1 else ys[:, 0]
        for j in range(2, fs):
            y = y + ys[:, j]
    back = y.reshape(n, E_l, m, C, d).transpose(1, 2) \
        .reshape(n, m, E_l * C, d)
    ret = back[e_line, e_idx[:, None]].reshape(n, E * C, d)
    out = _combine(ret, slot, keep, topv, T, k)        # (n, T, d)
    if mode == "tokens":
        out = out.reshape(n, fs, T_own, d)[torch.arange(n, device=x.device),
                                           f_idx]
    out = out.reshape(n, B_l, S_l, d).to(x.dtype)
    # the global result: each block from the rank at index 0 of the axes
    # its spec does not name (the replicas hold equal values)
    used = set(entry_axes(spec[0]) + entry_axes(spec[1]))
    owners = [r for r, c in enumerate(cs)
              if all(c[a] == 0 for a in mesh.axis_names if a not in used)]
    nb, ns = B // B_l, S // S_l
    grid = [[None] * ns for _ in range(nb)]
    for r in owners:
        c = cs[r]
        bi = _block(mesh, c, spec[0], B).start // B_l
        si = _block(mesh, c, spec[1], S).start // S_l
        grid[bi][si] = out[r]
    y = torch.cat([torch.cat(row, dim=1) for row in grid], dim=0)
    _tell_collectives(y, m, fs, mode, E_l * C * d * x.element_size(),
                      T * d * x.element_size())
    return y


def _tell_collectives(y, m: int, fs: int, mode: str, piece: int,
                      tokens: int) -> None:
    """Tell the active cost counter of one rank's collectives in
    ``moe_ep``: two all-to-alls of m pieces, and in 'tokens' mode the
    token all-gather and the psum of the expert outputs; those of the
    backward when it runs (a hook on the result).  The expert weights'
    all-gathers are FSDP's, which the dry run's plan counts."""
    def tell():
        cost.collective("all-to-all", m * piece, m, 2)
        if mode == "tokens":
            cost.collective("all-gather", tokens, fs)
            cost.collective("all-reduce", m * piece, fs)

    tell()
    if y.requires_grad and cost.ACTIVE:
        y.register_hook(lambda g: tell())


def moe_apply(x, p, cfg, ctx=NULL_CTX):
    """Full MoE block: routed experts (+ shared experts).  Expert-parallel
    when ``ctx`` asks for it on a mesh whose EP axis divides the experts:
    ``moe_ep`` on a rank of a group, ``moe_ep_ref`` in one process holding
    every shard; else ``moe_dense``."""
    if ctx.ep and ctx.mesh is not None and \
            cfg.num_experts % ctx.mesh.shape[ctx.ep_axis] == 0:
        if ctx.ep_group is not None:
            y = moe_ep(x, p, cfg, ctx)
        else:
            y = moe_ep_ref(x, p, cfg, ctx)
    else:
        y = moe_dense(x, p, cfg)
    if cfg.num_shared_experts:
        h = silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
        y = y + h @ p["shared_down"]
    return y
