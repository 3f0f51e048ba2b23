"""PagedTorchBackend: real PyTorch execution behind the Backend protocol,
the counterpart of the reference's ``PagedJaxBackend``.

A model prefills and decodes through the paged Model API
(``prefill_paged`` / ``decode_paged``) against one device-resident paged
KV cache.  Block tables come from the engine's ``BlockManager``, so the
one run loop (``ServeEngine``), every scheduler and eviction/swap work the
same over simulated and real execution.

Geometry: the pool holds ``num_blocks`` pages of ``page`` tokens plus ONE
scrap page (index ``num_blocks``) that absorbs the KV writes of padded
and retired rows; it never appears in a live block table.

Fixed row counts: a decode call runs on ``ROWS`` lanes (a batch of more
lanes on the next multiple of ``ROWS``, in one call), and a prefill chunk
runs as ``ROWS``-token calls.  GEMM and reduction libraries pick their
algorithm, and so their summation order, from the shape; padding to the
reference's power-of-two widths instead moves full-width bf16 logits and
prompt KV with the call shape (``chip_smoke.py`` measures it).  With one
shape per kind of call, a token's logits depend on its own sequence
alone, not on which requests shared its step or how its prompt was
chunked, so token streams do not depend on measured step times.  That
holds while decode batches stay within ``ROWS`` lanes (the engine's
default ``max_batch``).

Decode: ``decode_batch_n`` runs up to n micro-steps from one call.  The
sampled token feeds back as the next input and positions advance on the
device; lanes whose remaining output runs out switch to the all-scrap
table.  The host reads the results once per n tokens.  ``decode_batch``
is ``decode_batch_n(n=1)``, so streams are equal across horizons.

CUDA graphs: on the card at tp=1 each decode forward after the second of
its padded shape (B lanes, the table's width, fused or not) replays a
CUDA graph that ``Model.decode_paged`` captured of its eager forward, and
each prefill call after the second of its shape (``ROWS`` tokens, the
table's width) one that ``Model.prefill_paged`` captured, the chunk's
start and length filled into the graph's buffers on the device
(``models/paged_graphs.py``); the first call of a shape runs eager and
the second captures.  The replay launches the eager forward's kernels at
its shapes, in its order, on the same weights and pool, so its logits and
prompt KV are bitwise the eager forward's and the streams do not change.
Verify, the sampler and every call under tp > 1 run eager.  The registry
counts captures and replays (``torch_decode_graph_captures_total``,
``torch_decode_graph_replays_total``,
``torch_prefill_graph_captures_total``,
``torch_prefill_graph_replays_total``).

Speculative decoding: ``decode_verify_batch`` drafts up to the granted
depth per lane (``NgramDrafter`` by default), scores each drafted lane's
window in one ``Model.verify_paged`` forward (padded to ``ROWS`` lanes;
the live window rows are packed into ``ROWS``-row slabs, the decode
call's shape, so each live row's logits are bitwise a decode step's), and
accepts or rejects on the device.  Lanes without drafts ride a plain
one-token decode call in the same step; the host reads both results once.

Sampling is seeded per (seed, rid, pos) at any temperature (``Sampler``;
greedy at temperature 0), so streams do not depend on batch composition,
decode horizon or speculation.

Tensor parallelism (``tp`` > 1, DESIGN.md §8): ``tp`` ranks, this process
rank 0 and ``tp - 1`` worker processes (``serving/tp.py``), each hold
their shard of the weights (Megatron: attention heads, MLP d_ff, lm_head
vocab; embeddings, norms and MoE experts replicated) and of the page pool
(its KV-head dim).  Every device call (prefill chunks, decode windows,
verify forwards, KV page operations) runs on every rank with the same
host-side inputs; a forward all-reduces twice per layer (after ``wo`` and
after ``w_down``) and gathers the vocab once.  When ``num_kv_heads % tp
!= 0`` attention and its pool are replicated.  The engine sees the
mesh-wide pool: ``num_blocks * tp`` pages when attention shards.  Each
rank samples from logits that are bitwise equal on every rank, so every
rank feeds back the same tokens; each keeps a running hash of what it
sampled, and ``check_ranks`` (run at ``reset_run_state`` and ``close``)
raises if two ranks differ.
"""

from __future__ import annotations

import hashlib
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.archs import reduced_config
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.launch.sharding import (paged_page_specs, paged_param_specs,
                                         paged_tp_plan, serving_tp_ctx,
                                         shard_tree)
from repro_torch.models import paged_graphs as pg
from repro_torch.models.convert import (from_host, params_from_numpy,
                                        to_host, tree_leaves, tree_map)
from repro_torch.models.model import build_model, verify_slabs
from repro_torch.models.partition import NULL_CTX
from repro_torch.obs.spans import NULL_SPANS
from repro_torch.serving.backend import Backend, Sampler
from repro_torch.serving.drafter import NgramDrafter

ROWS = 64   # lanes of a decode call, tokens of a prefill call


def _rows(n: int) -> int:
    return ROWS * max(1, -(-n // ROWS))


def _rank_devices(tp: int, device, devices) -> List[torch.device]:
    """One device per rank.  ``devices`` wins (its first ``tp``); else
    ``device`` (None means "cuda", which CUDA must be available for): the
    CPU for every rank, or cuda:0..tp-1 when tp > 1.  Nothing falls back
    to the CPU."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) < tp:
            raise ValueError(f"tp={tp} needs {tp} devices, got {len(devs)}")
        return devs[:tp]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PagedTorchBackend runs on the GPU by default and CUDA "
                "is not available; pass device='cpu' for the plain "
                "PyTorch path")
        device = "cuda"
    dev = torch.device(device)
    if tp == 1 or dev.type == "cpu":
        return [dev] * tp
    n = torch.cuda.device_count()
    if n < tp:
        raise ValueError(
            f"tp={tp} needs {tp} CUDA devices, have {n} (ranks share one "
            f"card when given devices=['cuda:0'] * {tp})")
    return [torch.device("cuda", i) for i in range(tp)]


class PagedTorchBackend(Backend):
    supports_multi_step = True
    supports_spec_decode = True
    # wall-clock span recorder (obs/spans.py); off unless attached
    spans = NULL_SPANS

    def __init__(self, arch: str = "tinyllama-1.1b", num_blocks: int = 64,
                 page: int = 16, max_len: int = 128, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0,
                 overhead: float = 1e-4, interpret: bool = True,
                 tp: int = 1, devices=None, fused: bool = True,
                 drafter=None, device=None, reduced: bool = True,
                 config: Optional[ModelConfig] = None):
        """Keyword arguments as the reference's, plus ``device`` (None means
        "cuda", and raises RuntimeError without CUDA; the CPU runs the plain
        PyTorch versions of the kernels), ``reduced`` (True: the reduced
        CPU-test config; False: the full published width) and ``config``
        (a ``ModelConfig`` served in place of ``arch`` and ``reduced``,
        e.g. a published width at a cut depth).  ``drafter``
        proposes speculative drafts (default ``NgramDrafter()``).
        ``interpret`` is accepted for the reference's signature and unused:
        the CUDA kernels have no interpret mode.

        ``tp`` > 1 runs ``tp`` ranks.  ``devices`` (one per rank) as the
        reference's: None takes cuda:0..tp-1 and raises ValueError on a
        host with fewer cards; ranks share one card when given
        ``devices=["cuda:0"] * tp``; ``device="cpu"`` runs every rank on
        the CPU."""
        self.tp = max(int(tp), 1)
        devs = _rank_devices(self.tp, device, devices)
        args = dict(arch=arch, num_blocks=num_blocks, page=page,
                    max_len=max_len, seed=seed, temperature=temperature,
                    top_k=top_k, overhead=overhead, fused=fused,
                    reduced=reduced, config=config)
        group = None
        if self.tp > 1:
            from repro_torch.serving.tp import TPGroup
            if devs[0].type == "cuda":
                # built once here: the workers only load it
                from repro_torch.kernels import build
                build.build(["paged_attention"])
            group = TPGroup(args, devs)
        try:
            self._build(args, devs, 0, group.data if group else None)
            if group is not None:
                group.wait_ready()
        except BaseException:
            if group is not None:
                group.close(check=False)
            raise
        self._group = group
        if group is not None:
            weakref.finalize(self, group.close)
        self.drafter = drafter if drafter is not None else NgramDrafter()

    @classmethod
    def for_rank(cls, args: dict, devices, rank: int, data):
        """Rank ``rank``'s backend of a tensor-parallel group (built by the
        worker processes): ``args`` are rank 0's constructor arguments,
        ``data`` the rank's collective handle."""
        self = cls.__new__(cls)
        self.tp = len(devices)
        self._build(args, devices, rank, data)
        self._group = None
        self.drafter = NgramDrafter()
        return self

    def _build(self, a: dict, devices, rank: int, data) -> None:
        """Everything every rank holds: its shard of the weights and of the
        pool, the sampler, counters, geometry."""
        self.rank = rank
        self.device = devices[rank]
        config = a["config"]
        if config is None:
            config = reduced_config(a["arch"]) if a["reduced"] \
                else get_config(a["arch"])
        self.cfg = config
        self.plan = paged_tp_plan(self.cfg, self.tp)
        ctx = (serving_tp_ctx(self.cfg, self.tp, data) if self.tp > 1
               else NULL_CTX)
        self.data = data
        self.model = build_model(self.cfg, ctx)
        if not self.model.supports_paged():
            raise ValueError(
                f"{self.cfg.name}: paged serving needs a pure-attention "
                "stack with rope/none positions and no modality frontend "
                "(recurrent mixers have no paged state)")
        seed = a["seed"]
        self.sampler = Sampler(temperature=a["temperature"],
                               top_k=a["top_k"], seed=seed)
        # every rank draws the full weights from the seed and keeps its
        # shard, so the weights equal tp=1's
        full = self.model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        self._pspecs = paged_param_specs(self.cfg, self.tp, full)
        self.params = shard_tree(full, self._pspecs, rank, self.tp)
        del full
        self.page = a["page"]
        self.max_len = a["max_len"]
        self.n_max = -(-self.max_len // self.page)  # block-table width
        # a KV-head-sharded pool costs 1/tp of a page per rank, so the same
        # per-rank budget holds tp x the pages: the pool the engine
        # allocates from is the mesh-wide aggregate
        pool = a["num_blocks"] * (self.tp if self.plan["attn"] else 1)
        self.scrap = pool                        # pad rows write here
        # +1: the scrap page lives at the end of the pool, outside the
        # BlockManager's 0..pool-1 range
        full = self.model.init_paged_caches(pool + 1, self.page, self.device)
        self._gspecs = paged_page_specs(self.cfg, self.tp, full)
        self.pages = shard_tree(full, self._gspecs, rank, self.tp)
        del full
        self.overhead = a["overhead"]
        self.fused = bool(a["fused"])
        self.generated: Dict[int, List[int]] = {}
        self._prompts: Dict[int, np.ndarray] = {}
        self._host: Dict[int, object] = {}       # swapped-out page contents
        # queued prefill chunks of the current step; run before anything
        # reads the pages (decode / swap / sync)
        self._pf_queue: List[tuple] = []
        # per-rid padded block tables (rebuilt only when the table changes)
        self._tab_cache: Dict[int, tuple] = {}
        self._staging: Dict[int, tuple] = {}
        # dispatch accounting: calls, tokens, decode and verify forwards
        self.n_decode_dispatches = 0
        self.n_decode_tokens = 0
        self.n_decode_forwards = 0
        self.n_verify_forwards = 0
        self.n_prefill_dispatches = 0
        self._seed = seed
        self._t_acc = 0.0
        self._host_t0 = 0.0
        self._pages_step = 0
        # padded call shapes seen so far: ("decode", B, n) / ("prefill", C)
        # / ("verify", B, W, slabs)
        self._shapes: set = set()
        # tp > 1: a running hash of the tokens this rank sampled, and the
        # device results not yet folded into it
        self._hash = hashlib.blake2b(digest_size=8)
        self._unhashed: List[tuple] = []
        self.worker_exitcodes: List[int] = []     # set by close

        # engine-facing geometry (BlockManager mirrors the device pool).
        # kv_shard_degree is the factor each PAGE is split by across the
        # ranks: the replicated-KV fallback keeps full pages per rank, so
        # it stays 1 there even though tp > 1
        self.block_tokens = self.page
        self.num_blocks = pool
        self.kv_bytes = float(self.model.kv_bytes_per_token())
        self.kv_shard_degree = self.tp if self.plan["attn"] else 1
        self.attach_obs(self.obs)       # resolve no-op instruments

    # -- tensor-parallel plumbing -----------------------------------------
    def on_ranks(self, name: str, *args, gather: bool = False):
        """Run backend method ``name`` on every rank with the same
        host-side arguments: sent to the workers first, then run here.
        Returns rank 0's result, or with ``gather`` every rank's, in rank
        order."""
        if self._group is not None:
            self._group.send(name, args, reply=gather)
        out = getattr(self, name)(*args)
        if not gather:
            return out
        return [out] + (self._group.replies() if self._group else [])

    def _fold(self) -> None:
        for res in self._unhashed:
            for t in res:
                self._hash.update(t.cpu().numpy().tobytes())
        self._unhashed.clear()

    def _token_digest(self) -> str:
        self._fold()
        return self._hash.hexdigest()

    def check_ranks(self) -> None:
        """Raise unless every rank sampled the same tokens (tp > 1)."""
        if self._group is not None:
            self._group.check(self._token_digest())

    def _rank_stats(self, reset: bool) -> dict:
        from repro_torch.kernels import paged_attention as pa

        data = self.data
        out = dict(rank=self.rank, device=str(self.device),
                   launches=dict(pa.launches), tickets=pa.ticket_sum(),
                   digest=self._token_digest(),
                   collectives=data.n if data is not None else 0,
                   collective_s=data.seconds if data is not None else 0.0,
                   data=data.kind if data is not None else None)
        if reset:
            for k in pa.launches:
                pa.launches[k] = 0
            if data is not None:
                data.n, data.seconds = 0, 0.0
        return out

    def rank_stats(self, reset: bool = False) -> List[dict]:
        """Per rank, in rank order: the paged kernels' launch counts in the
        rank's process and their ticket counters summed (zero between
        launches), the sampled-token digest, and the data group's
        collectives and the host seconds spent in them.  ``reset`` zeroes
        the launch and collective counts after reading them."""
        return self.on_ranks("_rank_stats", bool(reset), gather=True)

    def decode_logits(self, tokens, positions, tables):
        """One decode forward's logits (B, V) f32, on rank 0's device, run
        on every rank: tokens (B, 1), positions (B,) and tables (B, n_max)
        int32 host arrays, the new tokens' KV written at ``positions``.
        For measurements; serving goes through ``decode_batch_n``."""
        return self.on_ranks("_logits_dev", tokens, positions, tables,
                             self.fused)

    def _logits_dev(self, tokens, positions, tables, fused: bool):
        logits, self.pages = self.model.decode_paged(
            self.params, self.pages, self._dev(tokens), self._dev(positions),
            self._dev(tables), fused=fused)
        return logits

    def close(self) -> None:
        """Check the ranks' hashes, then stop and join the workers (tp > 1;
        a no-op otherwise and after the first call); raises if a worker
        did not exit with code 0.  ``worker_exitcodes`` holds their codes
        afterwards."""
        group, self._group = self._group, None
        if group is None:
            return
        try:
            group.check(self._token_digest())
        finally:
            try:
                group.close()
            finally:
                self.worker_exitcodes = group.exitcodes

    def load_params(self, tree) -> None:
        """Install full (unsharded) weights in the reference's layout,
        numpy arrays or tensors, on every rank; each keeps its shard, in
        the dtype of the weights it replaces."""
        def host(a):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu()
                return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
            return np.asarray(a)
        self.on_ranks("_load_params_dev", tree_map(host, tree))

    def _load_params_dev(self, tree) -> None:
        mine = shard_tree(tree, self._pspecs, self.rank, self.tp)
        self.params = tree_map(
            lambda a, p: params_from_numpy(a, self.device, p.dtype),
            mine, self.params)

    def attach_spans(self, spans) -> None:
        """Record the backend's and its model's spans into ``spans``
        (``obs/spans.py``; ``NULL_SPANS`` turns the recorder off).  Under
        tp > 1 rank 0 alone records: the workers keep the default."""
        self.spans = spans
        self.model.spans = spans

    def attach_obs(self, obs) -> None:
        """Bind the run's metrics registry and pre-resolve the backend's
        instruments.  The engine calls this at construction; until then
        the class-level no-op registry holds."""
        self.obs = obs
        self._m_dispatch = obs.counter(
            "torch_dispatch_seconds_total",
            "host wall time inside the backend's dispatch calls (enqueue "
            "and the host's waits on the device), not device busy time")
        self._m_host = obs.counter(
            "torch_host_seconds_total",
            "host-side step time outside dispatch calls")
        self._m_pages = obs.counter(
            "torch_pages_touched_total",
            "block-table pages referenced by device calls")
        self._m_graphs = [
            (obs.counter(f"torch_{kind}_graph_captures_total",
                         f"{kind} forwards captured as CUDA graphs "
                         f"(Model.{kind}_paged)"),
             obs.counter(f"torch_{kind}_graph_replays_total",
                         f"{kind} forwards run as a replay of a CUDA graph"))
            for kind in pg.KINDS]
        self._graphs_told = self._graph_counts()

    def _graph_counts(self):
        g = self.model.graphs
        return [(g.captures[kind], g.replays[kind]) for kind in pg.KINDS]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _staging_bufs(self, B: int):
        bufs = self._staging.get(B)
        if bufs is None:
            bufs = (np.zeros((B, 1), np.int32),          # input tokens
                    np.zeros(B, np.int32),               # write positions
                    np.full((B, self.n_max), self.scrap, np.int32),
                    np.zeros(B, np.int32),               # remaining budget
                    np.zeros(B, np.int32))               # rids (sampling key)
            self._staging[B] = bufs
        return bufs

    # ------------------------------------------------------------------
    def prompt_ids(self, req) -> np.ndarray:
        """Prompt tokens: caller-supplied via req.meta['prompt_tokens'] or
        synthesized deterministically from (seed, rid), with the same
        numpy generator as the reference."""
        toks = self._prompts.get(req.rid)
        if toks is None:
            given = req.meta.get("prompt_tokens")
            if given is not None:
                toks = np.asarray(given, np.int32)
                if toks.shape[0] != req.prompt_len:
                    raise ValueError(
                        f"r{req.rid}: prompt_tokens length {toks.shape[0]} "
                        f"!= prompt_len {req.prompt_len}")
                if toks.size and int(toks.max()) >= self.cfg.vocab_size:
                    raise ValueError(
                        f"r{req.rid}: prompt token {int(toks.max())} out of "
                        f"vocab (vocab_size={self.cfg.vocab_size})")
            else:
                rng = np.random.default_rng(
                    (self._seed, req.rid & 0x7FFFFFFF))
                toks = rng.integers(0, self.cfg.vocab_size,
                                    size=req.prompt_len).astype(np.int32)
            self._prompts[req.rid] = toks
        return toks

    def _padded_table(self, rid: int, table: List[int]) -> np.ndarray:
        """Padded (n_max,) block table for rid, cached until the table's
        contents change."""
        tl = list(table)
        ent = self._tab_cache.get(rid)
        if ent is not None and ent[0] == tl:
            return ent[1]
        t = np.full(self.n_max, self.scrap, np.int32)
        t[:len(tl)] = tl
        self._tab_cache[rid] = (tl, t)
        return t

    # ------------------------------------------------------------------
    # Backend protocol
    # ------------------------------------------------------------------
    def begin_step(self) -> None:
        self._t_acc = 0.0
        self._pages_step = 0
        self._host_t0 = time.perf_counter()

    def reset_run_state(self) -> None:
        """Forget per-request state so one backend instance can serve a
        fresh run; weights, staging buffers and page geometry survive.
        Stale page content is invisible: the next run's prefills rewrite
        every position a context-masked read can reach.  Under tp > 1 the
        ranks' hashes are checked first."""
        self.check_ranks()
        self.on_ranks("_reset_dev")
        self.generated.clear()
        self._prompts.clear()
        self._tab_cache.clear()

    def _reset_dev(self) -> None:
        self._host.clear()
        self._pf_queue.clear()
        self.n_decode_dispatches = 0
        self.n_decode_tokens = 0
        self.n_decode_forwards = 0
        self.n_verify_forwards = 0
        self.n_prefill_dispatches = 0
        self._t_acc = 0.0
        self._pages_step = 0

    def prefill_chunk(self, req, start: int, n: int,
                      block_table: List[int]) -> None:
        if req.prompt_len + req.true_output_len > self.max_len:
            raise ValueError(
                f"r{req.rid}: {req.prompt_len}+{req.true_output_len} tokens "
                f"exceed max_len={self.max_len}; raise max_len or cap the "
                "workload (WorkloadSpec.prompt_cap/output_cap)")
        prompt = self.prompt_ids(req)
        C = _rows(n)
        self._pages_step += len(block_table)
        toks = np.zeros(C, np.int32)
        toks[:n] = prompt[start:start + n]
        # queue only; the step's one host sync happens in step_time
        self._pf_queue.append(
            (C, toks, start, self._padded_table(req.rid, block_table), n))
        self.generated.setdefault(req.rid, [])

    def _flush_prefill(self) -> None:
        """Run every queued prefill chunk as ROWS-token sub-chunks.  No
        sync here: the device drains in step_time."""
        q = self._pf_queue
        if not q:
            return
        self._pf_queue = []
        with self.spans.span("backend.prefill", rows=sum(c[0] for c in q),
                             tokens=sum(c[4] for c in q)):
            t0 = time.perf_counter()
            self.on_ranks("_prefill_dev", q)
            self._t_acc += time.perf_counter() - t0

    def _prefill_dev(self, q) -> None:
        for C, toks, start, tab, n in q:
            self.n_prefill_dispatches += 1
            self._shapes.add(("prefill", C))
            tok_t = self._dev(toks)[None, :]
            tab_t = self._dev(tab)
            for lo in range(0, C, ROWS):
                self.pages = self.model.prefill_paged(
                    self.params, self.pages, tok_t[:, lo:lo + ROWS],
                    start + lo, tab_t, min(ROWS, n - lo))

    def decode_batch(self, reqs: List, tables: List[List[int]]) -> None:
        """One real decode step for every request in the batch.

        Convention: the input token is the request's last token (prompt
        tail for the first step), written at position prompt_len-1+decoded;
        the first step rewrites the prompt tail's KV, so prefill needs no
        logits head and every emitted token flows through this one path."""
        if not reqs:
            return
        self.decode_batch_n(reqs, tables, 1)

    def _decode_dev(self, staged, n: int, fused: bool, sampler: Sampler):
        """A decode call of n micro-steps on this rank (see
        ``_decode_steps``).  ``staged``: host arrays (tokens, positions,
        tables, remaining budget, rids)."""
        self._fold()
        return self._decode_steps([self._dev(a) for a in staged], n, fused,
                                  sampler)

    def _decode_steps(self, staged, n: int, fused: bool, sampler: Sampler):
        """n decode micro-steps on the device, no host sync.  Each masks
        retired lanes (rem == 0) onto the scrap table, decodes, samples,
        feeds the token back, and advances active lanes' positions.
        Returns (tokens (B, n) int32, active (B, n) bool) on the device."""
        toks, pos, tabs, rem, rids = staged
        scrap_row = torch.full((1, self.n_max), self.scrap, dtype=torch.int32,
                               device=self.device)
        tok_n, act_n = [], []
        for _ in range(n):
            active = rem > 0
            tabs_eff = torch.where(active[:, None], tabs, scrap_row)
            logits, self.pages = self.model.decode_paged(
                self.params, self.pages, toks, pos, tabs_eff, fused=fused)
            self.n_decode_forwards += 1
            with self.spans.span("sampler"):
                nxt = sampler.sample_device(logits, rids, pos)
            tok_n.append(nxt)
            act_n.append(active)
            toks = torch.where(active, nxt, toks[:, 0])[:, None]
            step = active.to(pos.dtype)
            pos = pos + step
            rem = rem - step
        out = torch.stack(tok_n, dim=1), torch.stack(act_n, dim=1)
        self._record(out)
        return out

    def _record(self, res) -> None:
        """Queue a call's sampled results for the rank's hash (tp > 1); the
        next call folds them in before it launches anything."""
        if self.tp > 1:
            self._unhashed.append(res)

    def decode_batch_n(self, reqs: List, tables: List[List[int]], n: int):
        """Up to n decode micro-steps per request from one call.  Lanes
        retire to the scrap page when their true remaining output runs out
        mid-window; the host syncs once for the whole window.  Returns
        (tokens (B, n) int32, active (B, n) bool)."""
        if not reqs:
            return (np.zeros((0, n), np.int32), np.zeros((0, n), bool))
        self._flush_prefill()
        t0 = time.perf_counter()
        staged = self._stage_decode(reqs, tables, n)
        with self.spans.span("backend.decode", rows=staged[0].shape[0],
                             lanes=len(reqs)):
            tok_n, act_n = self.on_ranks("_decode_dev", staged, n,
                                         self.fused, self.sampler)
        with self.spans.span("backend.sync"):
            tok_n = tok_n.cpu().numpy()         # ONE host sync per n tokens
            act_n = act_n.cpu().numpy()
        self._t_acc += time.perf_counter() - t0
        return self._take_decode(reqs, n, tok_n, act_n)

    def _stage_decode(self, reqs: List, tables: List[List[int]], n: int):
        """Inputs of a decode call of n micro-steps, padded to ``ROWS``
        lanes, as host arrays: (tokens, positions, tables, remaining
        budget, rids)."""
        nr = len(reqs)
        B = _rows(nr)
        with self.spans.span("backend.stage", rows=B, lanes=nr):
            self._shapes.add(("decode", B, n))
            self._pages_step += sum(len(t) for t in tables) * n
            toks, pos, tabs, rem, rids = self._staging_bufs(B)
            toks[nr:] = 0
            pos[nr:] = 0
            tabs[nr:] = self.scrap
            rem[nr:] = 0
            rids[nr:] = 0
            for i, r in enumerate(reqs):
                gen = self.generated.setdefault(r.rid, [])
                prompt = self.prompt_ids(r)
                toks[i, 0] = gen[-1] if gen else prompt[-1]
                pos[i] = r.prompt_len - 1 + r.decoded
                tabs[i] = self._padded_table(r.rid, tables[i])
                rem[i] = max(0, min(n, r.true_output_len - r.decoded))
                rids[i] = r.rid & 0x7FFFFFFF
        return toks, pos, tabs, rem, rids

    def _take_decode(self, reqs: List, n: int, tok_n: np.ndarray,
                     act_n: np.ndarray):
        """Append a decode call's host-side results to the streams."""
        nr = len(reqs)
        self.n_decode_dispatches += 1
        self.n_decode_tokens += int(act_n[:nr].sum())
        for i, r in enumerate(reqs):
            gen = self.generated[r.rid]
            for s in range(n):
                if act_n[i, s]:
                    gen.append(int(tok_n[i, s]))
        return tok_n[:nr], act_n[:nr]

    # -- speculative decoding -------------------------------------------
    def decode_verify_batch(self, reqs: List, tables: List[List[int]],
                            depths: List[int]):
        """Draft-then-verify step: propose up to depths[i] tokens per lane
        from its prompt + generated history, score every drafted lane's
        window in one verify forward, and keep the longest accepted prefix
        plus the bonus token.  Every emitted token is the target model's
        own (seed, rid, pos)-keyed sample, so streams equal spec-off ones;
        rejected rows leave stale KV past the context, which the engine
        rolls back (``BlockManager.truncate``) and later steps overwrite.
        Lanes without drafts ride a plain one-token decode call.  Both
        calls' inputs are copied to the device before either launches
        (a copy from host memory waits for the device), and the host reads
        their results once.  Returns per-lane (emitted, accepted,
        proposed)."""
        if not reqs:
            return []
        self._flush_prefill()
        drafts = []
        for r, d in zip(reqs, depths):
            d = int(d)
            if d <= 0:
                drafts.append([])
                continue
            hist = list(self.prompt_ids(r)) + \
                self.generated.setdefault(r.rid, [])
            drafts.append(self.drafter.propose(hist, d)[:d])
        # lanes the drafter came up dry on take the plain decode call, as
        # the reference's do; sampling is (seed, rid, pos)-keyed, so the
        # split changes no token
        dr_ix = [i for i, d in enumerate(drafts) if d]
        pl_ix = [i for i, d in enumerate(drafts) if not d]
        pl_reqs = [reqs[i] for i in pl_ix]
        out: List = [None] * len(reqs)
        t0 = time.perf_counter()
        plain = verify = None
        if pl_ix:
            plain = self._stage_decode(pl_reqs, [tables[i] for i in pl_ix],
                                       1)
        if dr_ix:
            verify = self._stage_verify([reqs[i] for i in dr_ix],
                                        [tables[i] for i in dr_ix],
                                        [drafts[i] for i in dr_ix])
        plain, verify = self.on_ranks("_spec_dev", plain, verify, self.fused,
                                      self.sampler)
        # ONE host sync per step: the first read waits for both calls
        if plain is not None:
            tok, act = (t.cpu().numpy() for t in plain)
        if verify is not None:
            targets, emitted = (t.cpu().numpy() for t in verify)
        self._t_acc += time.perf_counter() - t0
        if plain is not None:
            _, act = self._take_decode(pl_reqs, 1, tok, act)
            for j, i in enumerate(pl_ix):
                out[i] = (int(act[j, 0]), 0, 0)
        if verify is not None:
            self.n_decode_dispatches += 1
            for j, i in enumerate(dr_ix):
                e = int(emitted[j])
                self.generated[reqs[i].rid].extend(
                    int(t) for t in targets[j, :e])
                out[i] = (e, e - 1, len(drafts[i]))
                self.n_decode_tokens += e
        return out

    def _stage_verify(self, reqs: List, tables: List[List[int]],
                      drafts: List[List[int]]):
        """Inputs of a verify call for drafted lanes, padded to ``ROWS``
        lanes (padding lanes at width 0 on the all-scrap table), as
        host arrays: (tokens (B, W), pos0, widths, tables, remaining budget,
        rids, live rows packed in ``ROWS``-row slabs).  The window width is
        exact: 1 + the longest draft."""
        nr = len(reqs)
        B = _rows(nr)
        W = 1 + max(len(d) for d in drafts)
        self._pages_step += sum(len(t) for t in tables)
        toks = np.zeros((B, W), np.int32)
        pos0 = np.zeros(B, np.int32)
        widths = np.zeros(B, np.int32)
        tabs = np.full((B, self.n_max), self.scrap, np.int32)
        rem = np.ones(B, np.int32)
        rids = np.zeros(B, np.int32)
        for j, (r, dr) in enumerate(zip(reqs, drafts)):
            gen = self.generated[r.rid]
            toks[j, 0] = gen[-1] if gen else self.prompt_ids(r)[-1]
            toks[j, 1:1 + len(dr)] = dr
            pos0[j] = r.prompt_len - 1 + r.decoded
            widths[j] = 1 + len(dr)
            tabs[j] = self._padded_table(r.rid, tables[j])
            rem[j] = max(1, r.true_output_len - r.decoded)
            rids[j] = r.rid & 0x7FFFFFFF
        slabs = verify_slabs(widths, W, ROWS)
        self._shapes.add(("verify", B, W, slabs.shape[0]))
        return toks, pos0, widths, tabs, rem, rids, slabs

    def _spec_dev(self, plain, verify, fused: bool, sampler: Sampler):
        """A speculative step on this rank: the plain decode call and the
        verify call (either may be None), both inputs copied to the device
        before either launches (a copy from host memory waits for the
        device)."""
        self._fold()
        plain = None if plain is None else [self._dev(a) for a in plain]
        verify = None if verify is None else [self._dev(a) for a in verify]
        return (None if plain is None
                else self._decode_steps(plain, 1, fused, sampler),
                None if verify is None else self._verify(verify, sampler))

    def _verify(self, staged, sampler: Sampler):
        """One verify forward plus the on-device accept, no host sync.
        Returns (targets (B, W), emitted (B,)), emitted clamped to the
        lane's remaining output."""
        toks, pos0, widths, tabs, rem, rids, slabs = staged
        logits, self.pages = self.model.verify_paged(
            self.params, self.pages, toks, pos0, widths, tabs, slabs)
        self.n_verify_forwards += 1
        targets, emitted = sampler.verify_device(logits, toks, rids,
                                                 pos0, widths)
        out = targets, torch.minimum(emitted, rem)
        self._record(out)
        return out

    # -- KV residency hooks (mirror BlockManager transitions 1:1) -------
    # Payloads are numpy trees in the reference's pool layout: unit leaves
    # are 5-D (num_units, pages, page, KV, D) and index their page dim 1.
    def _gather(self, leaf, table):
        return leaf[:, table] if leaf.ndim == 5 else leaf[table]

    def _scatter(self, leaf, table, saved) -> None:
        saved = from_host(saved, leaf)
        if leaf.ndim == 5:
            leaf[:, table] = saved
        else:
            leaf[table] = saved

    def _table(self, block_table: List[int]) -> torch.Tensor:
        return torch.as_tensor(block_table, dtype=torch.long,
                               device=self.device)

    def kv_swap_out(self, rid: int, block_table: List[int],
                    tokens: int) -> None:
        """Each rank keeps its own shard of rid's pages on its host."""
        self._tab_cache.pop(rid, None)
        if not block_table:
            return
        self._flush_prefill()     # the gather must see this step's writes
        self.on_ranks("_swap_out_dev", rid, list(block_table))

    def _swap_out_dev(self, rid: int, block_table: List[int]) -> None:
        table = self._table(block_table)
        self._host[rid] = tree_map(
            lambda p: to_host(self._gather(p, table)), self.pages)

    def kv_swap_in(self, rid: int, block_table: List[int]) -> None:
        if rid not in self._host:
            return
        self.on_ranks("_swap_in_dev", rid, list(block_table))

    def _swap_in_dev(self, rid: int, block_table: List[int]) -> None:
        saved = self._host.pop(rid)
        table = self._table(block_table)
        tree_map(lambda p, s: self._scatter(p, table, s), self.pages, saved)

    def kv_copy_page(self, src: int, dst: int) -> None:
        """COW fork: duplicate device page src into dst (the engine is
        about to append into a previously shared page).  Byte-exact."""
        self._flush_prefill()     # src must hold this step's writes
        self.on_ranks("_copy_page_dev", src, dst)

    def _copy_page_dev(self, src: int, dst: int) -> None:
        for p in tree_leaves(self.pages):
            if p.ndim == 5:
                p[:, dst] = p[:, src]
            else:
                p[dst] = p[src]

    def kv_release(self, rid: int) -> None:
        if rid in self._host:
            self.on_ranks("_drop_host_dev", rid)
        self._prompts.pop(rid, None)
        self._tab_cache.pop(rid, None)

    def _drop_host_dev(self, rid: int) -> None:
        self._host.pop(rid, None)

    # -- live KV migration ----------------------------------------------
    def kv_export_pages(self, rid: int, block_table: List[int]):
        """Host-staged export for replica-to-replica migration: rid's page
        contents (the kv_swap_out gather; under tp > 1 every rank's heads,
        so the payload has the unsharded layout) plus the prompt and
        generated tokens the destination needs to continue the stream.
        Per-request local state is dropped; the device pages are not
        cleared."""
        self._flush_prefill()     # the gather must see this step's writes
        parts = self.on_ranks("_export_dev", rid, list(block_table),
                              gather=True)
        pages = parts[0]
        if pages is not None and self.plan["attn"]:
            pages = tree_map(lambda *ps: np.concatenate(ps, axis=ps[0].ndim
                                                        - 2), *parts)
        payload = dict(pages=pages,
                       prompt=self._prompts.pop(rid, None),
                       generated=self.generated.pop(rid, None))
        self._tab_cache.pop(rid, None)
        return payload

    def _export_dev(self, rid: int, block_table: List[int]):
        if block_table:
            table = self._table(block_table)
            pages = tree_map(lambda p: to_host(self._gather(p, table)),
                             self.pages)
            self._host.pop(rid, None)
            return pages
        # swapped-out at export time: the host copy IS the content
        return self._host.pop(rid, None)

    def kv_import_pages(self, rid: int, payload,
                        block_table: Optional[List[int]]) -> None:
        """Install an exported payload: adopt the prompt/generated state
        and scatter the page contents into this pool (each rank its own
        heads), or park them host-side when ``block_table`` is None (the
        ordinary kv_swap_in path restores them once the engine frees
        blocks)."""
        if payload is None:
            return
        if payload.get("prompt") is not None:
            self._prompts[rid] = payload["prompt"]
        if payload.get("generated") is not None:
            self.generated[rid] = list(payload["generated"])
        pages = payload.get("pages")
        if pages is None:
            return
        self.on_ranks("_import_dev", rid, pages,
                      list(block_table) if block_table else None)

    def _import_dev(self, rid: int, pages, block_table) -> None:
        mine = shard_tree(pages, paged_page_specs(self.cfg, self.tp, pages),
                          self.rank, self.tp)
        if block_table:
            table = self._table(block_table)
            tree_map(lambda p, s: self._scatter(p, table, s), self.pages,
                     mine)
        else:
            self._host[rid] = mine

    def output_tokens(self, rid: int) -> Optional[List[int]]:
        """Real generated tokens (the engine registers prompt+output pages
        into the prefix cache under their true content hash)."""
        return self.generated.get(rid)

    # ------------------------------------------------------------------
    def step_time(self, prefill_tokens: int, decode_ctxs: List[int],
                  verify_tokens: int = 0) -> float:
        # verify_tokens is a cost-model hint; wall time already includes
        # any verification work, so it is accepted and ignored here
        self._flush_prefill()
        # the step's one host sync: drain everything queued above, so
        # _t_acc holds the host's time in dispatch calls and its waits
        with self.spans.span("backend.sync"):
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._t_acc += time.perf_counter() - t0
        if self.obs.enabled:
            # host share = wall since begin_step minus the time in
            # dispatch calls; metrics only, never fed back into the
            # simulated clock
            wall = time.perf_counter() - self._host_t0
            self._m_dispatch.inc(self._t_acc)
            self._m_host.inc(max(wall - self._t_acc, 0.0))
            self._m_pages.inc(self._pages_step)
            told, self._graphs_told = self._graphs_told, self._graph_counts()
            for ms, was, now in zip(self._m_graphs, told, self._graphs_told):
                for c, a, b in zip(ms, was, now):
                    c.inc(b - a)
        return self.overhead + self._t_acc
