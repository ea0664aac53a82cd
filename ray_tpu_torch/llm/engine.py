"""InferenceEngine — continuous batching over the paged KV cache, the
PyTorch port of ``ray_tpu/llm/engine.py`` (tp=1).

The scheduler is the JAX engine's, unchanged:
  - RAGGED SINGLE-LAUNCH STEP: every scheduler step packs the decode
    batch (one token per running sequence) and up to prefill_rows
    prefill CHUNKS (bounded by the step token budget) into one ragged
    token batch of fixed capacity and runs ONE ragged step;
  - pure-decode steps (no prefill work pending) run the multi-step
    decode loop instead: decode_chunk ragged steps with a single [K, B]
    readback;
  - PREFIX CACHE: full prompt KV pages publish into a hash-indexed table
    keyed by the KV storage scheme; a prompt sharing a page-aligned
    prefix maps those pages read-only (copy-on-write when its tail must
    write into a shared page) and prefills only the tail;
  - CHUNKED PREFILL under the per-step token budget, decode first;
  - INT8 KV (kv_dtype="int8"): int8 pages + bf16 per-(token, head)
    scales, quantize on write, dequantize inside the attention kernel;
  - preemption by recompute when the pool runs out.

Telemetry, as in the JAX engine: a per-request flight recorder
(``llm/request_log.py``, its hooks at the JAX engine's sites, every
timestamp ``time.monotonic()`` taken after the dispatch's tokens reached
the host), the engine gauges on the port's metrics plane (``_update_metrics``,
throttled to ~1/s), and ``compiled_step_programs()``: the distinct step
programs dispatched in this process, each step function per signature of
its arguments (the counterpart of the JAX engine's jit cache entries).

Not ported yet: tensor parallelism and the compile tracker (its journal
events need the runtime).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.config import llm_defaults
from ray_tpu_torch.llm import model as M
from ray_tpu_torch.llm.cache import (SCRATCH_PAGE, PageAllocator,
                                     PrefixCache, SequenceState,
                                     kv_cache_tag, make_kv_cache)
from ray_tpu_torch.llm.request_log import FlightRecorder
from ray_tpu_torch.models.llama import (LlamaConfig, init_params,
                                        resolve_device)
from ray_tpu_torch.ops.paged_attention import check_kernel_geometry
from ray_tpu_torch.util import metrics as metrics_mod

#: step programs dispatched in this process: (step function, its static
#: arguments, the signature of its tensor arguments). The JAX engine
#: counts the jit cache entries of its three module-level step functions,
#: which every engine of a process shares; this set is their counterpart.
_step_programs: set = set()
_step_programs_lock = threading.Lock()


def _signature(x):
    """Shapes, dtypes and device of a (nested dict of) tensor(s); the
    type of anything else (page indices are plain ints)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    return type(x).__name__


class _SingleChipFns:
    """Single-device step functions behind the engine's ``_fns`` seam
    (the JAX engine swaps a tensor-parallel set in at the same seam).
    The attention implementation follows the tensors' device."""

    def __init__(self, cfg: LlamaConfig, decode_chunk: int,
                 max_q_len: int, decode_rows: int):
        self.cfg = cfg
        self._chunk = decode_chunk
        self._max_q = max_q_len
        self._rows = decode_rows

    @staticmethod
    def _note_program(fn, static, args) -> None:
        key = (fn.__name__, static, tuple(_signature(a) for a in args))
        with _step_programs_lock:
            _step_programs.add(key)

    def ragged_step(self, params, tokens, token_pos, token_page,
                    token_slot, page_table, q_start, q_len, kv_len, kv):
        args = (params, tokens, token_pos, token_page, token_slot,
                page_table, q_start, q_len, kv_len, kv)
        self._note_program(M.ragged_step,
                           (self.cfg, self._max_q, self._rows), args)
        return M.ragged_step(*args, self.cfg, max_q_len=self._max_q,
                             decode_rows=self._rows)

    def decode_loop(self, params, tokens, positions, kv, page_table,
                    seq_lens):
        args = (params, tokens, positions, kv, page_table, seq_lens)
        self._note_program(M.ragged_decode_loop, (self.cfg, self._chunk),
                           args)
        return M.ragged_decode_loop(*args, num_steps=self._chunk,
                                    cfg=self.cfg)

    def copy_page(self, kv, src, dst):
        self._note_program(M.copy_page, (), (kv, src, dst))
        return M.copy_page(kv, src, dst)

    def compiled_step_programs(self) -> int:
        """Distinct step programs dispatched, process-wide (engines with
        equal shapes share them, as they share the JAX engine's jit
        caches). In a fresh process running one engine this is exactly
        that engine's program count."""
        with _step_programs_lock:
            return len(_step_programs)


def _cast_params(tree, dtype, device):
    """Every use of a weight casts it to cfg.dtype first, so storing it
    in cfg.dtype gives the same numbers (8B in bf16: ~16 GB, not 32).
    Detached: serving never differentiates the weights."""
    return {k: _cast_params(v, dtype, device) if isinstance(v, dict)
            else v.detach().to(device=device, dtype=dtype)
            for k, v in tree.items()}


class InferenceEngine:
    def __init__(self, cfg: LlamaConfig, params=None, *,
                 page_size: int = 16, total_pages: int = 256,
                 max_batch: int = 8, max_seq_len: int = 1024,
                 eos_token: Optional[int] = None, seed: int = 0,
                 decode_chunk: int = 8,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 step_token_budget: Optional[int] = None,
                 admit_lookahead: Optional[int] = None,
                 admit_age_cap_s: Optional[float] = None,
                 kv_dtype: Optional[str] = None,
                 prefill_rows: Optional[int] = None,
                 request_log: Optional[bool] = None,
                 device="cuda"):
        defaults = llm_defaults()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kv_dtype = defaults["llm_kv_dtype"] \
            if kv_dtype is None else kv_dtype
        if self.device.type == "cuda":
            # the attention kernels' geometry, checked before any work:
            # a geometry they do not take raises here, not in the first
            # step on a server's engine thread
            check_kernel_geometry(
                cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, page_size,
                cfg.dtype, torch.int8 if self.kv_dtype == "int8"
                else cfg.dtype)
        if params is None:
            params = init_params(cfg, seed, self.device)
        self.params = _cast_params(params, cfg.dtype, self.device)
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = -(-max_seq_len // page_size)
        self.eos_token = eos_token
        # tokens decoded per pure-decode launch group: one host readback
        # per K steps; finished sequences overshoot at most K-1 tokens
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = max(
            1, defaults["llm_prefill_chunk"] if prefill_chunk is None
            else prefill_chunk)
        self.step_token_budget = defaults["llm_step_token_budget"] \
            if step_token_budget is None else step_token_budget
        self.admit_lookahead = max(
            1, defaults["llm_admit_lookahead"] if admit_lookahead is None
            else admit_lookahead)
        self.admit_age_cap_s = defaults["llm_admit_age_cap_s"] \
            if admit_age_cap_s is None else admit_age_cap_s
        # ragged batch geometry: every mixed step carries max_batch decode
        # rows (inactive slots masked by q_len=0) plus prefill_rows chunk
        # rows of up to prefill_chunk tokens — ONE fixed shape
        self.prefill_rows = max(
            1, defaults["llm_ragged_prefill_rows"] if prefill_rows is None
            else prefill_rows)
        self.ragged_rows = max_batch + self.prefill_rows
        self.ragged_tokens = max_batch + self.prefill_rows \
            * self.prefill_chunk
        self.kv = make_kv_cache(cfg, total_pages, page_size,
                                kv_dtype=self.kv_dtype, device=self.device)
        self._fns = _SingleChipFns(cfg, self.decode_chunk,
                                   self.prefill_chunk, max_batch)
        self.allocator = PageAllocator(total_pages)
        use_prefix = defaults["llm_prefix_cache"] \
            if prefix_cache is None else prefix_cache
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(self.allocator, page_size,
                        kv_tag=kv_cache_tag(cfg, self.kv_dtype)) \
            if use_prefix else None
        self.waiting: List[SequenceState] = []
        self.running: List[SequenceState] = []
        # admitted sequences still computing prompt KV in chunks; they
        # hold a slot + pages but stay out of the decode rows
        self._chunking: List[SequenceState] = []
        self._slots: List[Optional[SequenceState]] = [None] * max_batch
        self._req_ids = itertools.count()
        self._rid_nonce = uuid.uuid4().hex[:6]
        self._lock = threading.Lock()
        # host-side decode inputs (fixed shapes)
        self._page_table = np.full((max_batch, self.max_pages_per_seq),
                                   SCRATCH_PAGE, np.int32)
        self._positions = np.zeros(max_batch, np.int32)
        self._tokens = np.zeros(max_batch, np.int32)
        self.stats = {"steps": 0, "prefill_tokens": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "decode_dispatches": 0, "cached_tokens": 0,
                      "ragged_dispatches": 0, "ragged_real_tokens": 0,
                      "ragged_slot_tokens": 0, "cow_copies": 0,
                      "preemptions": 0}
        # per-request flight recorder (llm/request_log.py): lifecycle
        # event stream per request + TTFT/TPOT/e2e/queue-wait histograms
        # + SLO attainment; None disables every hook (seq.record stays
        # None, so the step loop pays one is-None check per event)
        use_reclog = defaults["llm_request_log"] \
            if request_log is None else request_log
        self.request_log: Optional[FlightRecorder] = \
            FlightRecorder() if use_reclog else None
        self._finished_at_prefill: Dict[str, List[int]] = {}
        # tokens generated since the last drain_progress(), per live
        # request (opt-in: users that never drain must not accumulate)
        self.track_progress = False
        self._progress: Dict[str, List[int]] = {}
        # rid -> "stop" (EOS) | "length" | "evict"; bounded
        self._finish_reasons: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        # rid -> prompt tokens served from the prefix cache; bounded
        self._cached_counts: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        # engine gauges on the port's metrics plane (util/metrics.py)
        self._g_kv_util = metrics_mod.llm_kv_page_utilization_gauge()
        self._g_hit_rate = metrics_mod.llm_prefix_hit_rate_gauge()
        self._g_prefill_tps = metrics_mod.llm_prefill_tokens_per_s_gauge()
        self._g_decode_tps = metrics_mod.llm_decode_tokens_per_s_gauge()
        self._g_queue = metrics_mod.llm_queue_depth_gauge()
        self._g_programs = metrics_mod.llm_compiled_programs_gauge()
        self._g_dispatches = metrics_mod.llm_dispatches_per_step_gauge()
        self._g_pad_waste = metrics_mod.llm_padding_waste_gauge()
        self._g_slo_ttft = metrics_mod.llm_slo_ttft_attainment_gauge()
        self._g_slo_tpot = metrics_mod.llm_slo_tpot_attainment_gauge()
        self._g_preempts = metrics_mod.llm_preemptions_gauge()
        self._metrics_ts = time.monotonic()
        self._metrics_last = dict(self.stats)

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host int32 arrays -> device tensors through ONE copy."""
        flat = np.concatenate([a.ravel() for a in arrays])
        buf = torch.from_numpy(flat).to(self.device)
        out, off = [], 0
        for a in arrays:
            out.append(buf[off:off + a.size].view(a.shape))
            off += a.size
        return out

    # ------------------------------------------------------------ requests

    def add_request(self, prompt: List[int], max_new_tokens: int = 32,
                    trace_id: str = "") -> str:
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > \
                self.max_pages_per_seq * self.page_size:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        probe = SequenceState("probe", prompt, max_new_tokens)
        if probe.pages_needed(self.page_size, headroom=1) > \
                self.allocator.total_pages - 1:
            raise ValueError(
                f"prompt needs more pages than the cache holds "
                f"({self.allocator.total_pages - 1} allocatable)")
        rid = f"req-{self._rid_nonce}-{next(self._req_ids)}"
        seq = SequenceState(rid, prompt, max_new_tokens,
                            enqueue_ts=time.monotonic())
        if self.request_log is not None:
            # flight-recorder lifecycle starts at enqueue; the caller's
            # trace_id (the server's ambient trace) links record <-> trace
            seq.record = self.request_log.start(
                rid, len(prompt), max_new_tokens, trace_id=trace_id)
        with self._lock:
            self.waiting.append(seq)
        return rid

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.waiting or self.running or self._chunking)

    def compiled_step_programs(self) -> int:
        """Step programs dispatched for this engine's step functions,
        process-wide (O(1) by design: mixed ragged step, decode loop,
        COW copy)."""
        return self._fns.compiled_step_programs()

    # ---------------------------------------------------------------- step

    def step(self) -> Dict[str, List[int]]:
        """One scheduler step: admit waiting requests, then EITHER one
        ragged mixed step (prefill chunks under the token budget + one
        decode token per running sequence) when prefill work is pending,
        OR one multi-step decode loop when not. Returns {request_id:
        generated} for sequences that FINISHED this step."""
        finished: Dict[str, List[int]] = {}
        self._admit()
        if not self._ragged_dispatch(finished):
            self._decode(finished)
        if self._finished_at_prefill:
            finished.update(self._finished_at_prefill)
            self._finished_at_prefill = {}
        self.stats["steps"] += 1
        self._update_metrics()
        return finished

    # ---------------------------------------------------------- scheduling

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate, LRU-evicting unreferenced prefix-cache pages under
        pressure."""
        pages = self.allocator.alloc(n)
        if pages is None and self.prefix is not None:
            short = n - self.allocator.num_free
            if self.prefix.evict(short) >= short:
                pages = self.allocator.alloc(n)
        return pages

    def _release_pages(self, pages: List[int]) -> None:
        self.allocator.free(pages)
        if self.prefix is not None:
            self.prefix.note_release(pages)

    def _admit(self) -> None:
        """Admit waiting requests into the chunked-prefill pipeline (slot
        + pages reserved up front, prefix hits mapped read-only, COW when
        the tail writes into a shared page). The scan continues past
        requests that do not fit through a bounded lookahead, unless the
        head has waited admit_age_cap_s and fails for memory."""
        admitted: List[Tuple[SequenceState, List[int], List[int], bool]] = []
        with self._lock:
            if not self.waiting:
                return
            now = time.monotonic()
            head = self.waiting[0]
            head_aged = (now - head.enqueue_ts) > self.admit_age_cap_s
            free_slots = [i for i, s in enumerate(self._slots)
                          if s is None]
            for seq in list(self.waiting[:self.admit_lookahead]):
                if not free_slots:
                    break
                matched_pages: List[int] = []
                matched, cow = 0, False
                if self.prefix is not None:
                    matched_pages, matched, cow = \
                        self.prefix.match(seq.prompt)
                need = seq.pages_needed(self.page_size, headroom=1) \
                    - len(matched_pages) + (1 if cow else 0)
                tail_pages = self._alloc_pages(need)
                if tail_pages is None:
                    if matched_pages:
                        self._release_pages(matched_pages)
                    if seq.record is not None:
                        seq.record.note_stall(now)
                    if seq is head and head_aged:
                        break  # aged head waits for memory first
                    continue
                slot = free_slots.pop(0)
                self.waiting.remove(seq)
                seq.slot = slot
                seq.prefilling = True
                seq.num_computed = matched
                seq.cached_tokens = matched
                if seq.record is not None:
                    seq.record.note_admit(now, matched)
                self._slots[slot] = seq
                admitted.append((seq, matched_pages, tail_pages, cow))
        for seq, matched_pages, tail_pages, cow in admitted:
            if cow:
                # tail writes land inside the last shared page: copy it,
                # then drop our reference to the original
                cow_page = tail_pages.pop(0)
                orig = matched_pages[-1]
                self.kv = self._fns.copy_page(self.kv, orig, cow_page)
                self._release_pages([orig])
                matched_pages = matched_pages[:-1] + [cow_page]
                self.stats["cow_copies"] += 1
            seq.pages = matched_pages + tail_pages
            self.stats["cached_tokens"] += seq.cached_tokens
            self._note_cached(seq.request_id, seq.cached_tokens)
            self._chunking.append(seq)

    # --------------------------------------------------- ragged mixed step

    def _ragged_dispatch(self, finished: Dict[str, List[int]]) -> bool:
        """Assemble and run ONE ragged mixed step, if prefill work is
        pending: decode rows first (slot r owns ragged token r), then up
        to prefill_rows chunk rows packed from token max_batch on, FIFO
        under the step token budget. Returns False when no chunk work
        exists, sending the step to the pure-decode loop instead."""
        budget = self.step_token_budget \
            if self.step_token_budget > 0 else (1 << 30)
        rows: List[Tuple[SequenceState, int]] = []
        for seq in self._chunking:
            if len(rows) >= self.prefill_rows:
                break
            C = min(self.prefill_chunk,
                    len(seq.prompt) - seq.num_computed, budget)
            if C <= 0:
                break  # step token budget exhausted
            rows.append((seq, C))
            budget -= C
        if not rows:
            return False
        # decode rows advance one token: they need a page for it
        for slot, seq in list(enumerate(self._slots)):
            if seq is not None and not seq.prefilling:
                self._ensure_pages(slot, seq, 1, finished)
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        ps = self.page_size
        Tcap, R = self.ragged_tokens, self.ragged_rows
        tokens = np.zeros(Tcap, np.int32)
        token_pos = np.zeros(Tcap, np.int32)
        token_page = np.full(Tcap, SCRATCH_PAGE, np.int32)
        token_slot = np.zeros(Tcap, np.int32)
        q_start = np.zeros(R, np.int32)
        q_len = np.zeros(R, np.int32)
        kv_len = np.zeros(R, np.int32)
        ptab = np.full((R, self.max_pages_per_seq), SCRATCH_PAGE,
                       np.int32)
        q_start[:self.max_batch] = np.arange(self.max_batch,
                                             dtype=np.int32)
        ptab[:self.max_batch] = self._page_table
        for i, s in active:
            pos = int(self._positions[i])
            tokens[i] = self._tokens[i]
            token_pos[i] = pos
            token_page[i] = self._page_table[i, pos // ps]
            token_slot[i] = pos % ps
            q_len[i] = 1
            kv_len[i] = s.num_tokens
        t0 = self.max_batch
        for j, (seq, C) in enumerate(rows):
            r = self.max_batch + j
            start = seq.num_computed
            pos = np.arange(start, start + C, dtype=np.int32)
            tokens[t0:t0 + C] = seq.prompt[start:start + C]
            token_pos[t0:t0 + C] = pos
            pages = np.asarray(seq.pages, np.int32)
            token_page[t0:t0 + C] = pages[pos // ps]
            token_slot[t0:t0 + C] = pos % ps
            ptab[r, :len(seq.pages)] = pages
            q_start[r] = t0
            q_len[r] = C
            kv_len[r] = start + C
            t0 += C
        nxt, self.kv = self._fns.ragged_step(
            self.params, *self._to_device(
                tokens, token_pos, token_page, token_slot, ptab, q_start,
                q_len, kv_len), self.kv)
        nxt = nxt.cpu().numpy()                    # [R], ONE readback
        now = time.monotonic()                     # the tokens are here
        chunk_tokens = sum(C for _, C in rows)
        self.stats["ragged_dispatches"] += 1
        disp_idx = self.stats["ragged_dispatches"]
        self.stats["ragged_real_tokens"] += len(active) + chunk_tokens
        self.stats["ragged_slot_tokens"] += Tcap
        self.stats["prefill_tokens"] += chunk_tokens
        if active:
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(active)
        for slot, seq in active:
            tok = int(nxt[slot])
            if self.eos_token is not None and tok == self.eos_token:
                self._note_finish(seq.request_id, "stop")
                self._finish(slot, seq, finished)
                continue
            seq.generated.append(tok)
            if seq.record is not None:
                seq.record.note_decode(now, 1)
            if self.track_progress:
                self._progress.setdefault(seq.request_id, []).append(tok)
            if len(seq.generated) >= seq.max_new_tokens:
                self._finish(slot, seq, finished)
                continue
            self._tokens[slot] = tok
            self._positions[slot] = seq.num_tokens - 1
        for j, (seq, C) in enumerate(rows):
            seq.num_computed += C
            if seq.record is not None:
                seq.record.note_chunk(now, C, disp_idx)
            if seq.num_computed >= len(seq.prompt):
                self._chunking.remove(seq)
                seq.prefilling = False
                self._postfill_book(seq, seq.slot, seq.pages,
                                    int(nxt[self.max_batch + j]))
                if not seq.done:
                    # reserve the decode-loop headroom NOW, before the
                    # next admission scan hands these pages away
                    self._ensure_pages(seq.slot, seq,
                                       self.decode_chunk, finished)
        return True

    def _postfill_book(self, seq: SequenceState, slot: int,
                       pages: List[int], first_tok: int) -> None:
        """Post-prefill bookkeeping: publish full prompt pages into the
        prefix cache, then either finish immediately (EOS / 1-token
        budget) or join the decode batch with the first token."""
        seq.pages = pages
        if self.prefix is not None:
            self.prefix.register(seq.prompt, pages)
        now = time.monotonic()
        if seq.restore_generated:
            # recompute re-prefill done: unfold the prompt/generated split
            seq.prompt = seq.prompt[:seq.n_prompt]
            seq.generated = list(seq.restore_generated)
            seq.restore_generated = []
        eos_now = self.eos_token is not None and first_tok == self.eos_token
        if seq.record is not None:
            if eos_now:
                seq.record.note_first(now)  # sampled, but never emitted
            else:
                seq.record.note_decode(now, 1)
        if eos_now or len(seq.generated) + 1 >= seq.max_new_tokens:
            # the first sampled token is EOS (drop it) or uses up the
            # token budget (keep it): finish without joining the batch
            new = [] if eos_now else [first_tok]
            out = seq.generated + new
            seq.generated = out
            seq.done = True
            self._finished_at_prefill[seq.request_id] = out
            if new and self.track_progress:
                self._progress.setdefault(seq.request_id, []).extend(new)
            self._note_finish(seq.request_id,
                              "stop" if eos_now else "length")
            if self.request_log is not None and seq.record is not None:
                self.request_log.finish(
                    seq.record, now, "stop" if eos_now else "length")
            self._release_pages(pages)
            if seq.slot is not None:
                self._slots[seq.slot] = None
                self._page_table[seq.slot, :] = SCRATCH_PAGE
                seq.slot = None
            return
        seq.generated.append(first_tok)
        if self.track_progress:
            self._progress.setdefault(seq.request_id, []).append(first_tok)
        seq.slot = slot
        self._slots[slot] = seq
        with self._lock:
            self.running.append(seq)
        self._page_table[slot, :] = SCRATCH_PAGE
        self._page_table[slot, :len(pages)] = pages
        self._positions[slot] = seq.num_tokens - 1
        self._tokens[slot] = first_tok

    def _finish(self, slot: int, seq: SequenceState,
                finished: Dict[str, List[int]]) -> None:
        if seq.request_id not in self._finish_reasons:
            self._note_finish(seq.request_id, "length")
        if self.request_log is not None and seq.record is not None:
            self.request_log.finish(
                seq.record, time.monotonic(),
                self._finish_reasons.get(seq.request_id, "length"))
        seq.done = True
        finished[seq.request_id] = list(seq.generated)
        self._release_pages(seq.pages)
        self._slots[slot] = None
        self._page_table[slot, :] = SCRATCH_PAGE
        with self._lock:
            self.running.remove(seq)

    def _ensure_pages(self, slot: int, seq: SequenceState, headroom: int,
                      finished: Dict[str, List[int]]) -> bool:
        """Pages for num_tokens + headroom. False = preempted for lack of
        cache memory."""
        need = min(seq.pages_needed(self.page_size, headroom=headroom),
                   self.max_pages_per_seq)
        while len(seq.pages) < need:
            extra = self._alloc_pages(1)
            if extra is None:
                self._preempt(slot, seq, finished)
                return False
            self._page_table[slot, len(seq.pages)] = extra[0]
            seq.pages.extend(extra)
        return True

    #: recompute-preemptions allowed per sequence before it finishes
    #: "evict" — bounds ping-pong livelock
    PREEMPT_CAP = 4

    def _preempt(self, slot: int, seq: SequenceState,
                 finished: Dict[str, List[int]]) -> None:
        """Recompute preemption: drop the sequence's pages and re-queue it
        at the waiting head with its generated tokens folded into the
        prompt; greedy sampling makes the continuation identical."""
        now = time.monotonic()
        if seq.record is not None:
            seq.record.note_stall(now)
        need_all = -(-(seq.num_tokens + 1) // self.page_size)
        if seq.preempt_count >= self.PREEMPT_CAP \
                or need_all > self.allocator.total_pages - 1:
            self._note_finish(seq.request_id, "evict")
            self._finish(slot, seq, finished)
            return
        seq.preempt_count += 1
        self.stats["preemptions"] += 1
        if seq.record is not None:
            seq.record.note_preempt(now)
        self._release_pages(seq.pages)
        seq.pages = []
        self._slots[slot] = None
        self._page_table[slot, :] = SCRATCH_PAGE
        seq.slot = None
        seq.restore_generated = list(seq.generated)
        seq.prompt = seq.prompt + seq.generated
        seq.generated = []
        seq.num_computed = 0
        seq.cached_tokens = 0
        seq.prefilling = False
        with self._lock:
            if seq in self.running:
                self.running.remove(seq)
            self.waiting.insert(0, seq)

    # ----------------------------------------------------- pure decode

    def _decode(self, finished: Dict[str, List[int]]) -> None:
        for slot, seq in list(enumerate(self._slots)):
            if seq is not None and not seq.prefilling:
                self._ensure_pages(slot, seq, self.decode_chunk, finished)
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        if not active:
            return
        K = self.decode_chunk
        seq_lens = np.ones(self.max_batch, np.int32)
        for i, s in active:
            seq_lens[i] = s.num_tokens
        tokens, positions, ptab, lens = self._to_device(
            self._tokens, self._positions, self._page_table, seq_lens)
        toks_out, self.kv, _, _ = self._fns.decode_loop(
            self.params, tokens, positions, self.kv, ptab, lens)
        block = toks_out.cpu().numpy()             # [K, B], ONE readback
        now = time.monotonic()                     # the tokens are here
        self.stats["decode_steps"] += K
        self.stats["decode_tokens"] += K * len(active)
        self.stats["decode_dispatches"] += 1
        for slot, seq in active:
            n_new, fin = 0, False
            for j in range(K):
                tok = int(block[j, slot])
                if self.eos_token is not None and tok == self.eos_token:
                    self._note_finish(seq.request_id, "stop")
                    fin = True
                    break
                seq.generated.append(tok)
                n_new += 1
                if self.track_progress:
                    self._progress.setdefault(seq.request_id,
                                              []).append(tok)
                if len(seq.generated) >= seq.max_new_tokens:
                    fin = True
                    break
            # ONE record entry per dispatch (the K-step loop is one
            # readback: per-token host timestamps would be fiction),
            # noted BEFORE _finish so e2e covers every token
            if n_new and seq.record is not None:
                seq.record.note_decode(now, n_new)
            if fin:
                self._finish(slot, seq, finished)
            else:
                self._tokens[slot] = int(block[K - 1, slot])
                self._positions[slot] = seq.num_tokens - 1

    def drain_progress(self) -> Dict[str, List[int]]:
        """Tokens generated since the previous drain, per request id
        (requires track_progress = True)."""
        out, self._progress = self._progress, {}
        return out

    def _note_finish(self, rid: str, reason: str) -> None:
        self._finish_reasons[rid] = reason
        while len(self._finish_reasons) > 1024:
            self._finish_reasons.popitem(last=False)

    def finish_reason(self, rid: str) -> str:
        """Why rid stopped: "stop" (EOS), "length" or "evict" (pops)."""
        return self._finish_reasons.pop(rid, "length")

    def _note_cached(self, rid: str, n: int) -> None:
        if n <= 0:
            return
        self._cached_counts[rid] = n
        while len(self._cached_counts) > 1024:
            self._cached_counts.popitem(last=False)

    def cached_tokens(self, rid: str) -> int:
        """Prompt tokens rid served from the prefix cache (pops)."""
        return self._cached_counts.pop(rid, 0)

    # ------------------------------------------------------------- metrics

    def _update_metrics(self, force: bool = False) -> None:
        """Engine gauges on the port's metrics plane, throttled to ~1/s.
        The JAX engine's compile-invariant journal event waits for the
        runtime; the program count is the gauge here."""
        now = time.monotonic()
        dt = now - self._metrics_ts
        if dt < 1.0 and not force:
            return
        s, last = self.stats, self._metrics_last
        self._metrics_last = dict(s)
        self._metrics_ts = now
        allocatable = self.allocator.total_pages - 1   # page 0 = scratch
        self._g_kv_util.set(1.0 - self.allocator.num_free / allocatable)
        cached = s["cached_tokens"]
        denom = cached + s["prefill_tokens"]
        self._g_hit_rate.set(cached / denom if denom else 0.0)
        if dt > 0:
            self._g_prefill_tps.set(
                (s["prefill_tokens"] - last["prefill_tokens"]) / dt)
            self._g_decode_tps.set(
                (s["decode_tokens"] - last["decode_tokens"]) / dt)
        # ragged-step visibility: step programs dispatched (O(1) by
        # design), dispatches per scheduler step, and the padding
        # fraction of ragged token slots over the gauge window
        self._g_programs.set(float(self.compiled_step_programs()))
        d_steps = s["steps"] - last["steps"]
        if d_steps > 0:
            disp = sum(s[k] - last[k] for k in
                       ("ragged_dispatches", "decode_dispatches",
                        "cow_copies"))
            self._g_dispatches.set(disp / d_steps)
        d_slots = s["ragged_slot_tokens"] - last["ragged_slot_tokens"]
        if d_slots > 0:
            d_real = s["ragged_real_tokens"] - last["ragged_real_tokens"]
            self._g_pad_waste.set(1.0 - d_real / d_slots)
        if self.request_log is not None:
            a_ttft, a_tpot = self.request_log.slo_attainment()
            self._g_slo_ttft.set(a_ttft)
            self._g_slo_tpot.set(a_tpot)
        self._g_preempts.set(float(s["preemptions"]))
        with self._lock:
            self._g_queue.set(len(self.waiting))

    # ------------------------------------------------------------ blocking

    def generate(self, prompt: List[int], max_new_tokens: int = 32,
                 ) -> List[int]:
        """Synchronous single-request helper (tests, simple use)."""
        rid = self.add_request(prompt, max_new_tokens)
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            done = self.step()
            if rid in done:
                return done[rid]
            if not self.has_work():
                raise RuntimeError(f"request {rid} vanished")
        raise TimeoutError("generate timed out")
