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

Sampling is greedy (temperature 0) in this port; see ``Sampler``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.archs import reduced_config
from repro_torch.configs.base import get_config
from repro_torch.models.convert import (from_host, to_host, tree_leaves,
                                        tree_map)
from repro_torch.models.model import build_model
from repro_torch.serving.backend import Backend, Sampler

ROWS = 64   # lanes of a decode call, tokens of a prefill call


def _rows(n: int) -> int:
    return ROWS * max(1, -(-n // ROWS))


class PagedTorchBackend(Backend):
    supports_multi_step = True
    supports_spec_decode = False

    def __init__(self, arch: str = "tinyllama-1.1b", num_blocks: int = 64,
                 page: int = 16, max_len: int = 128, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0,
                 overhead: float = 1e-4, interpret: bool = True,
                 tp: int = 1, devices=None, fused: bool = True,
                 drafter=None, device=None, reduced: bool = True):
        """Keyword arguments as the reference's, plus ``device`` (None means
        "cuda", and raises RuntimeError without CUDA; the CPU runs the plain
        PyTorch versions of the kernels) and ``reduced`` (True: the reduced
        CPU-test config; False: the full published width).  ``interpret``,
        ``devices`` and ``drafter`` are accepted for the reference's
        signature and unused: the CUDA kernels have no interpret mode, and
        neither tensor parallelism nor speculative decoding is ported."""
        if int(tp) > 1:
            raise NotImplementedError(
                "tensor parallelism (tp > 1) is not ported")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PagedTorchBackend runs on the GPU by default and CUDA "
                    "is not available; pass device='cpu' for the plain "
                    "PyTorch path")
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = reduced_config(arch) if reduced else get_config(arch)
        self.model = build_model(self.cfg)
        if not self.model.supports_paged():
            raise ValueError(
                f"{arch}: paged serving needs a pure-attention stack with "
                "rope/none positions (recurrent mixers have no paged state)")
        self.sampler = Sampler(temperature=temperature, top_k=top_k,
                               seed=seed)
        if temperature > 0.0:
            raise NotImplementedError(
                "temperature > 0 is not ported; use temperature=0")
        self.params = self.model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        self.page = page
        self.max_len = max_len
        self.n_max = -(-max_len // page)         # block-table width
        self.scrap = num_blocks                  # pad rows write here
        # +1: the scrap page lives at the end of the pool, outside the
        # BlockManager's 0..num_blocks-1 range
        self.pages = self.model.init_paged_caches(num_blocks + 1, page,
                                                  self.device)
        self.overhead = overhead
        self.fused = bool(fused)
        self.generated: Dict[int, List[int]] = {}
        self._prompts: Dict[int, np.ndarray] = {}
        self._host: Dict[int, object] = {}       # swapped-out page contents
        # queued prefill chunks of the current step; run before anything
        # reads the pages (decode / swap / sync)
        self._pf_queue: List[tuple] = []
        # per-rid padded block tables (rebuilt only when the table changes)
        self._tab_cache: Dict[int, tuple] = {}
        self._staging: Dict[int, tuple] = {}
        # dispatch accounting: calls, tokens, and decode forwards
        self.n_decode_dispatches = 0
        self.n_decode_tokens = 0
        self.n_decode_forwards = 0
        self.n_prefill_dispatches = 0
        self._seed = seed
        self._t_acc = 0.0
        self._host_t0 = 0.0
        self._pages_step = 0
        # padded call shapes seen so far: ("decode", B, n) / ("prefill", C)
        self._shapes: set = set()

        # engine-facing geometry (BlockManager mirrors the device pool)
        self.block_tokens = page
        self.num_blocks = num_blocks
        self.kv_bytes = float(self.model.kv_bytes_per_token())
        self.kv_shard_degree = 1
        self.attach_obs(self.obs)       # resolve no-op instruments

    def attach_obs(self, obs) -> None:
        """Bind the run's metrics registry and pre-resolve the backend's
        instruments.  The engine calls this at construction; until then
        the class-level no-op registry holds."""
        self.obs = obs
        self._m_device = obs.counter(
            "torch_device_seconds_total",
            "wall time inside device calls, synchronisation included")
        self._m_host = obs.counter(
            "torch_host_seconds_total",
            "host-side step time outside device calls")
        self._m_pages = obs.counter(
            "torch_pages_touched_total",
            "block-table pages referenced by device calls")

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
        every position a context-masked read can reach."""
        self.generated.clear()
        self._prompts.clear()
        self._host.clear()
        self._pf_queue.clear()
        self._tab_cache.clear()
        self.n_decode_dispatches = 0
        self.n_decode_tokens = 0
        self.n_decode_forwards = 0
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
        t0 = time.perf_counter()
        for C, toks, start, tab, n in q:
            self.n_prefill_dispatches += 1
            self._shapes.add(("prefill", C))
            tok_t = self._dev(toks)[None, :]
            tab_t = self._dev(tab)
            for lo in range(0, C, ROWS):
                self.pages = self.model.prefill_paged(
                    self.params, self.pages, tok_t[:, lo:lo + ROWS],
                    start + lo, tab_t, min(ROWS, n - lo))
        self._t_acc += time.perf_counter() - t0

    def decode_batch(self, reqs: List, tables: List[List[int]]) -> None:
        """One real decode step for every request in the batch.

        Convention: the input token is the request's last token (prompt
        tail for the first step), written at position prompt_len-1+decoded;
        the first step rewrites the prompt tail's KV, so prefill needs no
        logits head and every emitted token flows through this one path."""
        if not reqs:
            return
        self.decode_batch_n(reqs, tables, 1)

    def _decode_n(self, toks, pos, tabs, rem, rids, n: int):
        """n decode micro-steps on the device, no host sync.  Each masks
        retired lanes (rem == 0) onto the scrap table, decodes, samples,
        feeds the token back, and advances active lanes' positions.
        Returns (tokens (B, n) int32, active (B, n) bool) on the device."""
        scrap_row = torch.full((1, self.n_max), self.scrap, dtype=torch.int32,
                               device=self.device)
        tok_n, act_n = [], []
        for _ in range(n):
            active = rem > 0
            tabs_eff = torch.where(active[:, None], tabs, scrap_row)
            logits, self.pages = self.model.decode_paged(
                self.params, self.pages, toks, pos, tabs_eff,
                fused=self.fused)
            self.n_decode_forwards += 1
            nxt = self.sampler.sample_device(logits, rids, pos)
            tok_n.append(nxt)
            act_n.append(active)
            toks = torch.where(active, nxt, toks[:, 0])[:, None]
            step = active.to(pos.dtype)
            pos = pos + step
            rem = rem - step
        return torch.stack(tok_n, dim=1), torch.stack(act_n, dim=1)

    def decode_batch_n(self, reqs: List, tables: List[List[int]], n: int):
        """Up to n decode micro-steps per request from one call.  Lanes
        retire to the scrap page when their true remaining output runs out
        mid-window; the host syncs once for the whole window.  Returns
        (tokens (B, n) int32, active (B, n) bool)."""
        if not reqs:
            return (np.zeros((0, n), np.int32), np.zeros((0, n), bool))
        self._flush_prefill()
        nr = len(reqs)
        B = _rows(nr)
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
        t0 = time.perf_counter()
        tok_n, act_n = self._decode_n(self._dev(toks), self._dev(pos),
                                      self._dev(tabs), self._dev(rem),
                                      self._dev(rids), n)
        tok_n = tok_n.cpu().numpy()         # ONE host sync per n tokens
        act_n = act_n.cpu().numpy()
        self._t_acc += time.perf_counter() - t0
        self.n_decode_dispatches += 1
        self.n_decode_tokens += int(act_n[:nr].sum())
        for i, r in enumerate(reqs):
            gen = self.generated[r.rid]
            for s in range(n):
                if act_n[i, s]:
                    gen.append(int(tok_n[i, s]))
        return tok_n[:nr], act_n[:nr]

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
        self._tab_cache.pop(rid, None)
        if not block_table:
            return
        self._flush_prefill()     # the gather must see this step's writes
        table = self._table(block_table)
        self._host[rid] = tree_map(
            lambda p: to_host(self._gather(p, table)), self.pages)

    def kv_swap_in(self, rid: int, block_table: List[int]) -> None:
        saved = self._host.pop(rid, None)
        if saved is None:
            return
        table = self._table(block_table)
        tree_map(lambda p, s: self._scatter(p, table, s), self.pages, saved)

    def kv_copy_page(self, src: int, dst: int) -> None:
        """COW fork: duplicate device page src into dst (the engine is
        about to append into a previously shared page).  Byte-exact."""
        self._flush_prefill()     # src must hold this step's writes
        for p in tree_leaves(self.pages):
            if p.ndim == 5:
                p[:, dst] = p[:, src]
            else:
                p[dst] = p[src]

    def kv_release(self, rid: int) -> None:
        self._host.pop(rid, None)
        self._prompts.pop(rid, None)
        self._tab_cache.pop(rid, None)

    # -- live KV migration ----------------------------------------------
    def kv_export_pages(self, rid: int, block_table: List[int]):
        """Host-staged export for replica-to-replica migration: rid's page
        contents (the kv_swap_out gather) plus the prompt and generated
        tokens the destination needs to continue the stream.  Per-request
        local state is dropped; the device pages are not cleared."""
        self._flush_prefill()     # the gather must see this step's writes
        if block_table:
            table = self._table(block_table)
            pages = tree_map(lambda p: to_host(self._gather(p, table)),
                             self.pages)
        else:
            # swapped-out at export time: the host copy IS the content
            pages = self._host.get(rid)
        payload = dict(pages=pages,
                       prompt=self._prompts.pop(rid, None),
                       generated=self.generated.pop(rid, None))
        self._host.pop(rid, None)
        self._tab_cache.pop(rid, None)
        return payload

    def kv_import_pages(self, rid: int, payload,
                        block_table: Optional[List[int]]) -> None:
        """Install an exported payload: adopt the prompt/generated state
        and scatter the page contents into this pool, or park them
        host-side when ``block_table`` is None (the ordinary kv_swap_in
        path restores them once the engine frees blocks)."""
        if payload is None:
            return
        if payload.get("prompt") is not None:
            self._prompts[rid] = payload["prompt"]
        if payload.get("generated") is not None:
            self.generated[rid] = list(payload["generated"])
        pages = payload.get("pages")
        if pages is None:
            return
        if block_table:
            table = self._table(block_table)
            tree_map(lambda p, s: self._scatter(p, table, s), self.pages,
                     pages)
        else:
            self._host[rid] = pages

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
        # the step's one host sync: drain everything queued above so
        # _t_acc is honest device time (credited as device seconds)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._t_acc += time.perf_counter() - t0
        if self.obs.enabled:
            # host share = wall since begin_step minus accumulated device
            # time; metrics only, never fed back into the simulated clock
            wall = time.perf_counter() - self._host_t0
            self._m_device.inc(self._t_acc)
            self._m_host.inc(max(wall - self._t_acc, 0.0))
            self._m_pages.inc(self._pages_step)
        return self.overhead + self._t_acc
