"""Backend protocol: one run loop, two execution substrates.

``ServeEngine`` owns request lifecycle, KV block accounting, and SLO
tracking; *how* a step's work is executed is delegated to a ``Backend``:

  ``SimBackend``      — roofline-derived step-time model of a TPU v5e
                        serving replica (reproduces the paper's figures at
                        laptop scale).  All KV/token hooks are no-ops.
  ``PagedTorchBackend`` — (torch_backend.py) a real model decoding
                        through the paged Model API against a
                        device-resident paged KV cache whose block tables
                        come from the engine's ``BlockManager``.  Step time
                        is measured wall time.

The hook contract mirrors the engine's bookkeeping exactly — every call
happens AFTER the corresponding ``BlockManager`` transition succeeded, so a
backend can mirror block residency 1:1:

  begin_step()                      — start of ``_execute``; reset timers
  prefill_chunk(req, start, n, tb) — append prompt tokens [start, start+n)
  decode_batch(reqs, tables)        — one token for every listed request
  decode_batch_n(reqs, tables, n)   — up to n tokens per request in ONE
                                      dispatch (supports_multi_step only)
  kv_swap_out(rid, table, tokens)   — blocks about to be freed (host copy)
  kv_swap_in(rid, table)            — blocks reallocated; restore contents
  kv_copy_page(src, dst)            — COW fork: duplicate page src -> dst
  kv_release(rid)                   — request finished; drop state
  output_tokens(rid)                — generated tokens (None if simulated)
  step_time(prefill_tokens, ctxs)   — the step's duration (model or wall)

Backends may advertise ``block_tokens`` / ``num_blocks`` so the engine
sizes its ``BlockManager`` to the device page pool's true geometry, and
``kv_bytes`` (bytes per KV token) for swap-cost accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import NULL
from repro_torch.serving.kvcache import KV_BYTES_PER_TOKEN
from repro_torch.serving.prng import gumbel_rows


class Backend:
    """Default no-op hooks; subclasses override what they need."""

    # per-token KV footprint (swap cost) — shared geometry constant
    kv_bytes: float = KV_BYTES_PER_TOKEN
    block_tokens: Optional[int] = None  # page size; None -> engine default
    num_blocks: Optional[int] = None    # pool size; None -> EngineConfig
    # metrics registry handle (repro.obs); the engine rebinds it at
    # construction so backend profiling shares the run's registry
    obs = NULL

    def attach_obs(self, obs) -> None:
        self.obs = obs

    def begin_step(self) -> None:
        pass

    def prefill_chunk(self, req, start: int, n: int,
                      block_table: List[int]) -> None:
        pass

    def decode_batch(self, reqs: List, tables: List[List[int]]) -> None:
        pass

    # multi-step decode (DESIGN.md §10): backends that can run n decode
    # micro-steps inside ONE dispatch advertise supports_multi_step and
    # implement decode_batch_n; the engine's fast path only engages when
    # the flag is set, so simulated backends keep exact single-step
    # semantics (and unchanged baselines) without any fallback looping
    supports_multi_step: bool = False

    def decode_batch_n(self, reqs: List, tables: List[List[int]],
                       n: int):
        """Run up to ``n`` decode micro-steps for every listed request in
        one dispatch.  Returns (tokens (B, n) int32, active (B, n) bool):
        ``active[i, s]`` marks micro-step ``s`` as real for lane ``i`` —
        lanes retire (stop decoding, route KV writes to the scrap page)
        once their remaining output is exhausted, so ``tokens[i, s]`` is
        meaningful only where active."""
        raise NotImplementedError

    # speculative decoding (DESIGN.md §11): backends that can score a
    # drafted window and accept/reject it advertise supports_spec_decode
    # and implement decode_verify_batch; the engine's spec path only
    # engages when the flag is set AND the scheduler grants nonzero depth
    supports_spec_decode: bool = False

    def decode_verify_batch(self, reqs: List, tables: List[List[int]],
                            depths: List[int]):
        """One draft-then-verify step for every listed request: draft up
        to ``depths[i]`` tokens for lane ``i``, score the whole window
        (last accepted token + drafts) in one device call, and keep the
        longest accepted prefix plus the bonus token.  Lanes with depth 0
        ride along as plain one-token decode rows.  Returns a list of
        per-lane ``(emitted, accepted, proposed)`` — tokens emitted this
        step (>= 1), draft tokens accepted, draft tokens proposed."""
        raise NotImplementedError

    def kv_swap_out(self, rid: int, block_table: List[int],
                    tokens: int) -> None:
        pass

    def kv_swap_in(self, rid: int, block_table: List[int]) -> None:
        pass

    def kv_copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork: duplicate device page src into dst before
        the engine appends into a previously shared page."""
        pass

    def kv_release(self, rid: int) -> None:
        pass

    # -- live KV migration (DESIGN.md §12) -----------------------------
    # Replica-to-replica page transfer: a prefill replica exports a
    # request's pages, the cluster prices the wire via migrate_time, and
    # the decode replica imports them.  The jax backend stages real page
    # contents through host numpy; simulated backends hold no content, so
    # the default payload (None) round-trips fine.

    # interconnect bandwidth between replicas (B/s) for transfer pricing
    # (bytes / bandwidth, same roofline style as step_time).  ~25 GB/s is
    # a conservative datacenter-network figure — well under the 60 GB/s
    # host swap path, so migration is never accidentally free.
    interconnect_bw: float = 25e9

    def migrate_time(self, nbytes: float) -> float:
        """Seconds to move `nbytes` of KV to a peer replica."""
        return nbytes / self.interconnect_bw

    def kv_export_pages(self, rid: int, block_table: List[int]):
        """Package rid's KV pages (plus any per-request generation state)
        for migration to another replica, dropping local state.  Returns
        an opaque payload for the destination's kv_import_pages."""
        return None

    def kv_import_pages(self, rid: int, payload,
                        block_table: Optional[List[int]]) -> None:
        """Install an exported payload under rid.  ``block_table`` names
        the destination pages; ``None`` parks the payload host-side as
        swapped-out state (arrival under pool pressure) for the ordinary
        kv_swap_in path to restore later."""
        pass

    def output_tokens(self, rid: int) -> Optional[List[int]]:
        """Tokens actually generated for rid, if the backend knows them —
        the engine registers prompt+output pages into the prefix cache
        from real content when available (simulated backends return None
        and the workload's synthetic output tokens are used instead)."""
        return None

    def step_time(self, prefill_tokens: int, decode_ctxs: List[int],
                  verify_tokens: int = 0) -> float:
        """``verify_tokens``: extra drafted positions scored this step
        beyond the one token per lane a plain decode step computes
        (speculative verification work).  Measured-wall-time backends
        ignore it; model-based backends must price it."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Sampler:
    """Seeded temperature/top-k sampling, deterministic per (rid, position).

    The RNG is keyed on (seed, rid, pos) — NOT on batch composition — so a
    request's token stream is identical regardless of which other sequences
    shared its decode batches (scheduler-order-proof determinism).
    ``temperature <= 0`` is greedy argmax."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def sample(self, logits: np.ndarray, rid: int, pos: int) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / self.temperature
        if self.top_k > 0 and self.top_k < z.size:
            kth = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= kth, z, -np.inf)
        rng = np.random.default_rng(
            (self.seed, rid & 0x7FFFFFFF, pos & 0x7FFFFFFF))
        g = rng.gumbel(size=z.shape)
        return int(np.argmax(z + g))

    def sample_device(self, logits, rids, poss):
        """Batched sampling on the logits' device.

        logits (B, V) f32; rids/poss (B,) int32.  Greedy argmax returns the
        first maximum, as the host path and ``jnp.argmax`` do.  At
        temperature > 0 the logits are divided by the temperature (filled
        on the device: a host scalar would make CUDA multiply by its
        reciprocal, and a host-made tensor would wait for the device), cut
        to the top k (``z >= kth largest``, as ``jax.lax.top_k``), and
        perturbed by a Gumbel row keyed per (seed, rid, pos) with the
        reference's threefry ``fold_in`` chain (``prng.gumbel_rows``): a
        request's stream depends on (seed, rid, pos) alone, never on batch
        composition, and matches the JAX package's given equal logits (up
        to Gumbel values that ``log`` rounds differently, which can flip a
        near tie)."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        z = logits.float() / torch.full((), self.temperature,
                                        dtype=torch.float32,
                                        device=logits.device)
        V = z.shape[-1]
        if 0 < self.top_k < V:
            kth = torch.topk(z, self.top_k, dim=-1).values[..., -1:]
            z = torch.where(z >= kth, z, float("-inf"))
        g = gumbel_rows(self.seed, rids, poss, V)
        return torch.argmax(z + g, dim=-1).to(torch.int32)

    def verify_device(self, logits, inputs, rids, pos0, widths):
        """On-device speculative accept/reject, as the reference's.

        logits (B, W, V): the verify forward's logits at every window
        position; inputs (B, W) int32: the window's input tokens (row 0 the
        last accepted token, rows 1.. the drafts); pos0 (B,): row 0's
        position; widths (B,): live rows per lane.  Returns (targets (B, W)
        int32, emitted (B,) int32).

        targets[b, s] is the token sampled at position pos0 + s by the same
        (seed, rid, pos)-keyed ``sample_device`` that plain decoding uses,
        so it is the token the sequential path emits there.  A draft is
        accepted iff it equals its position's target; the emitted prefix
        targets[b, :emitted[b]] is the leading run of accepted live drafts
        plus one bonus token."""
        B, W, V = logits.shape
        steps = torch.arange(W, dtype=pos0.dtype, device=logits.device)
        poss = pos0[:, None] + steps[None, :]
        flat = self.sample_device(logits.reshape(B * W, V),
                                  rids.repeat_interleave(W),
                                  poss.reshape(-1))
        targets = flat.reshape(B, W)
        if W == 1:
            return targets, torch.ones(B, dtype=torch.int32,
                                       device=logits.device)
        # draft s (input row s+1) is checked against target row s
        m = (inputs[:, 1:] == targets[:, :-1]) & \
            (steps[None, 1:] < widths[:, None])
        accepted = torch.cumprod(m.to(torch.int32), dim=1).sum(dim=1)
        return targets, (accepted + 1).to(torch.int32)


# ---------------------------------------------------------------------------
class SimBackend(Backend):
    """Step-time model: t = overhead + prefill_compute + decode_hbm.

    Prefix-cache pricing is inherited from the engine: ``prefill_tokens``
    is the sum of chunks actually computed (cache hits shrink it), while
    ``decode_ctxs`` carry the FULL context length — cached KV is skipped
    at prefill but still read on every decode step, exactly like a real
    replica."""

    # the sim prices verify windows and models accept runs, so every
    # scheduler/router/cluster test exercises the engine's spec path
    supports_spec_decode: bool = True

    def __init__(self, n_params: float = 8e9,
                 kv_bytes_per_token: float = KV_BYTES_PER_TOKEN,
                 chips: int = 8, peak_flops: float = 197e12,
                 hbm_bw: float = 819e9, mfu: float = 0.45,
                 overhead: float = 0.004, spec_accept_rate: float = 0.7,
                 seed: int = 0):
        self.n_params = n_params
        self.kv_bytes = kv_bytes_per_token
        self.chips = chips
        self.flops = peak_flops * chips * mfu
        self.bw = hbm_bw * chips * 0.7
        self.overhead = overhead
        self.spec_accept_rate = spec_accept_rate
        self.seed = seed

    def decode_verify_batch(self, reqs: List, tables: List[List[int]],
                            depths: List[int]):
        """Simulated draft-then-verify: the accept run for a lane is a
        deterministic Bernoulli(``spec_accept_rate``) leading run keyed on
        (seed, rid, decoded) — independent of batch composition and of
        which step the lane reaches that decode offset on, mirroring the
        real backend's composition-proof determinism."""
        out = []
        for r, d in zip(reqs, depths):
            d = int(d)
            if d <= 0:
                out.append((1, 0, 0))
                continue
            rng = np.random.default_rng(
                (self.seed, r.rid & 0x7FFFFFFF, r.decoded))
            acc = 0
            while acc < d and rng.random() < self.spec_accept_rate:
                acc += 1
            out.append((acc + 1, acc, d))
        return out

    def step_time(self, prefill_tokens: int, decode_ctxs: List[int],
                  verify_tokens: int = 0) -> float:
        t = self.overhead
        if prefill_tokens:
            t += 2.0 * self.n_params * prefill_tokens / self.flops
        if len(decode_ctxs):               # list or ndarray
            weights = 2.0 * self.n_params / self.bw
            kv = sum(decode_ctxs) * self.kv_bytes / self.bw
            t += weights + kv
        if verify_tokens:
            # extra drafted positions are compute-bound like prefill
            # tokens: the weights are already resident for the decode
            # pass, verification just widens the matmuls
            t += 2.0 * self.n_params * verify_tokens / self.flops
        return t

    def step_time_batch(self, prefill_tokens, decode_ctx_sums,
                        decode_lane_counts, verify_tokens=None) -> np.ndarray:
        """Price M steps in ONE numpy pass — elementwise identical to M
        ``step_time`` calls (fleet-sweep hot path, DESIGN.md §13).

        ``prefill_tokens[i]``: prompt tokens computed in step i;
        ``decode_ctx_sums[i]``: sum of full context lengths over step i's
        decode lanes; ``decode_lane_counts[i]``: how many decode lanes
        (gates the weight-read term exactly like a non-empty ctx list);
        ``verify_tokens[i]``: extra drafted positions scored."""
        pf = np.asarray(prefill_tokens, dtype=np.float64)
        kv = np.asarray(decode_ctx_sums, dtype=np.float64)
        ln = np.asarray(decode_lane_counts, dtype=np.float64)
        t = np.full(pf.shape, float(self.overhead))
        t += np.where(pf > 0, 2.0 * self.n_params * pf / self.flops, 0.0)
        t += np.where(ln > 0,
                      2.0 * self.n_params / self.bw
                      + kv * self.kv_bytes / self.bw, 0.0)
        if verify_tokens is not None:
            vt = np.asarray(verify_tokens, dtype=np.float64)
            t += np.where(vt > 0,
                          2.0 * self.n_params * vt / self.flops, 0.0)
        return t

    @classmethod
    def for_model(cls, name: str = "llama-8b", **kw):
        presets = {
            "llama-8b": dict(n_params=8e9,
                             kv_bytes_per_token=KV_BYTES_PER_TOKEN, chips=8),
            "qwen-14b": dict(n_params=14e9, kv_bytes_per_token=196608,
                             chips=8),
            "llama-70b": dict(n_params=70e9, kv_bytes_per_token=327680,
                              chips=32),
        }
        d = presets[name]
        d.update(kw)
        return cls(**d)
