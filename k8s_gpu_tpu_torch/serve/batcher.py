"""Continuous batching: the port of ``k8s_gpu_tpu/serve/batcher.py``,
composed of the scheduler, allocator and executor mixins.

A fixed pool of ``slots`` decode rows, on one of two KV pools:

- dense (``paged_blocks=0``, the default): ``[L, slots, KH, max_seq,
  Dh]``, one row a slot.  A request is prefilled left-padded to its
  bucket into its slot's row; ``precache_prefix`` keeps prefilled
  prefixes in a small LRU of rows, and a prompt that starts with one
  computes only its suffix;
- paged (``paged_blocks`` > 0): ``paged_blocks`` blocks of
  ``page_size`` positions shared by all slots through per-slot page
  tables (block 0 is the trash block).  With ``prefix_cache`` prefix
  sharing is block-granular and automatic: full prompt pages are
  chain-hashed and registered, a later prompt with the same chain maps
  its table to the same blocks and computes only its suffix, and a
  partial tail block is recomputed into a private block.  Without it
  every admission is a left-padded prefill whose row splices into fresh
  blocks.  The paged pool's registered blocks export and import over
  the reference's migration wire (``migrate_export``/``migrate_import``
  under ``run_quiesced``).

``role`` is the disaggregated-serving role: ``"prefill"`` clamps every
budget to the admission's one token and refuses decode rounds;
``"decode"`` and ``"both"`` serve normally.

``draft`` turns on speculative rounds on either pool: a ``(model,
params)`` pair (a neural draft with its own dense cache; ``draft_int8``
runs its products int8 x int8) or ``"ngram"`` (prompt lookup over each
row's history).  ``spec_k`` is the first draft window; it then adapts.

``adapters`` (name -> (LoRA tree, ``LoraConfig``)) serves every adapter
and the base model in the same rounds (``lora_bank.AdapterBank`` on the
batcher's device; a request picks one with ``adapter=``).
``constraints`` (a ``constrain.ConstraintBank``, moved to the batcher's
device) masks each constrained row's tokens by its DFA state (a request
picks one with ``constraint=``).  ``submit_precomputed`` admits a row
prefilled elsewhere (``disagg.DisaggregatedLm``).

``mesh`` (a ``parallel.mesh`` mesh of dp and tp over the initialized
world, one process a rank; ``params`` this rank's shards) serves on the
mesh: heads over tp (the engine), the dense pool's rows over dp
(``slots`` must divide over dp), the paged pool whole on every dp group.
Global rank 0 schedules and every rank runs each device program
(``meshed.py``); on the other ranks ``start()`` runs that loop and
``submit`` raises.  Everything above runs there: both drafts (a neural
draft's ``params`` are this rank's shards too, its engine on the same
mesh, its cache rows cut over dp as the target's; ``draft_int8``
quantizes the whole draft and cuts it), MoE, int8 weights (the whole
tree quantized, then cut: ``quant.shard_quantized``), int8 KV, the
adapter bank (cut by the adapters' logical axes), block migration
(whole heads on the wire) and ``submit_precomputed``.  A mesh refuses
what the reference refuses: an axis other than dp and tp, KV heads
(the draft's too) that do not divide over tp, and dense-pool slots
that do not divide over dp.

``profiler`` (a serve-plane ``utils.profiler.PhaseProfiler``, a new one
on ``metrics`` by default) times the scheduler thread's phases, always
on as in the reference: the shares land in ``serve_phase_share{phase}``.
A request that carries a trace context records its ``serve.queue_wait``,
``serve.prefill`` and ``serve.round`` spans in
``utils.tracing.global_tracer``.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..utils.compat import install_compile_telemetry
from ..utils.metrics import MetricsRegistry, global_metrics
from ..utils.profiler import PhaseProfiler
from .allocator import AllocatorMixin
from ..parallel.mesh import axis_rank, axis_size
from .engine import InferenceEngine
from .executor import ExecutorMixin
from .journal import RequestJournal
from .kv_blocks import BlockPool
from .lora_bank import AdapterBank
from .quant import quantized_bytes
from .scheduler import (
    Overloaded, RequestHandle, SchedulerMixin, prompt_bucket,
)

__all__ = ["ContinuousBatcher", "Overloaded", "RequestHandle",
           "prompt_bucket"]

ROLES = ("both", "prefill", "decode")


class ContinuousBatcher(SchedulerMixin, AllocatorMixin, ExecutorMixin):
    """Fixed-slot continuous batching over one InferenceEngine, on
    ``device`` (the card unless the caller asks for the CPU).

    ``eos_id`` retires a request early; ``logprobs`` collects per-token
    log-probabilities; ``kv_quant`` stores the pool int8; ``attn_impl``
    picks the paged read ("gather" or "paged_kernel"; the dense pool's
    read is the engine's plain one either way); ``paged_blocks`` > 0
    picks the paged pool; ``prefix_cache=False`` turns off both prefix
    planes (the dense entry cache and block sharing); ``max_pending`` >
    0 bounds the unadmitted queue (``submit`` raises ``Overloaded`` at
    the bound).  ``metrics``: the registry of the serve-plane series
    (the process-wide one by default; give each replica its own);
    ``role``: ``both``, ``prefill`` or ``decode``.  ``journal``: the
    per-request record ring to write (a new one when None).
    ``profiler``: the serve-plane phase profiler (a new one on
    ``metrics`` when None).  ``draft``/``spec_k``/``draft_int8``: the speculative rounds;
    ``adapters``, ``constraints``: the adapter and constraint banks
    (module docstring; a bank needs ``eos_id`` >= 0)."""

    def __init__(self, model, params, *, slots: int = 8, mesh=None,
                 max_seq: int | None = None, eos_id: int = -1,
                 steps_per_round: int = 8, pipeline_depth: int = 2,
                 adapters=None, constraints=None, logprobs: bool = False,
                 draft=None, spec_k: int = 4, draft_int8: bool = False,
                 kv_quant: bool = False,
                 attn_impl: str | None = None, paged_blocks: int = 0,
                 page_size: int = 64, prefix_cache: bool = True,
                 max_pending: int = 0,
                 metrics: MetricsRegistry | None = None,
                 journal: RequestJournal | None = None,
                 profiler: PhaseProfiler | None = None,
                 role: str = "both", device="cuda"):
        if draft is not None and constraints is not None and getattr(
                constraints, "banked", constraints) is not None:
            raise ValueError(
                "speculative decoding and a ConstraintBank cannot be "
                "combined: the DFA advances token-by-token through the "
                "ACCEPTED prefix, which only exists after the verify"
            )
        if mesh is not None:
            dp = axis_size(mesh, "dp")
            if int(paged_blocks) <= 0 and slots % dp:
                # The paged pool is whole on every dp group: any count.
                raise ValueError(
                    f"slots={slots} must divide over 'dp'={dp}: the pool "
                    "cache's batch axis shards it")
        if role not in ROLES:
            raise ValueError(f"unknown batcher role {role!r}")
        self.role = role
        self.metrics = metrics if metrics is not None else global_metrics
        self.journal = journal if journal is not None else RequestJournal()
        self.profiler = (profiler if profiler is not None
                         else PhaseProfiler(plane="serve",
                                            registry=self.metrics))
        # A kernel library built mid-serving stalls every row:
        # xla_compiles_total / xla_compile_seconds make it a live rate
        # CompileStorm pages on.
        install_compile_telemetry()
        self.device = resolve_device(device)
        self.engine = InferenceEngine(
            model, max_seq=max_seq, kv_quant=kv_quant, attn_impl=attn_impl,
            mesh=mesh, device=self.device,
        )
        self.mesh = mesh
        self.bank = AdapterBank(adapters or {}, device=self.device,
                                mesh=mesh, base_axes=model.logical_axes())
        banked = constraints is not None and constraints.banked is not None
        if banked and int(constraints.allowed.shape[2]) != \
                model.cfg.vocab_size:
            raise ValueError(
                f"ConstraintBank built over {constraints.allowed.shape[2]} "
                f"token strings but the model's vocab is "
                f"{model.cfg.vocab_size}: compile the bank against this "
                "model's tokenizer"
            )
        if banked and eos_id < 0:
            # A dead-ended constrained row retires by emitting EOS.
            raise ValueError(
                "ContinuousBatcher with a ConstraintBank requires eos_id >= "
                "0: a dead-ended constrained row retires by emitting EOS"
            )
        self.cbank = (constraints.to(self.device)
                      if constraints is not None else None)
        self.draft_engine = None
        self.draft_params = None
        self.spec_mode = None
        self.spec_k = max(1, int(spec_k))
        if isinstance(draft, str):
            if draft != "ngram":
                raise ValueError(
                    f"unknown draft mode {draft!r}: pass 'ngram' or a "
                    "(draft_model, draft_params) pair"
                )
            self.spec_mode = "ngram"
        elif draft is not None:
            draft_model, draft_params = draft
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    "draft and target must share a vocabulary "
                    f"({draft_model.cfg.vocab_size} != "
                    f"{model.cfg.vocab_size})"
                )
            # Same max_seq: the draft's rows line up with the target's.
            self.draft_engine = InferenceEngine(
                draft_model, max_seq=self.engine.max_seq, mesh=mesh,
                int8_compute=draft_int8, device=self.device,
            )
            if draft_int8:
                from .speculative import int8_draft

                draft_params = int8_draft(
                    draft_params, draft_model.logical_axes(), mesh)
            self.draft_params = draft_params
            self.spec_mode = "neural"
        self.params = params
        self.slots = slots
        self.eos_id = eos_id
        self.collect_logprobs = bool(logprobs)
        self.steps_per_round = max(1, int(steps_per_round))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.solo_buckets = [self.steps_per_round * m
                             for m in (1, 2, 3, 4, 6, 8)]

        self.page_size = max(8, int(page_size))
        self.paged = int(paged_blocks) > 0
        cfg, max_seq = self.engine.cfg, self.engine.max_seq
        # This rank's rows: the dense pool's slice of them over dp, or all
        # of them (the paged pool is whole on every dp group).
        self._rows = slots
        self._row0 = 0
        if not self.paged and axis_size(mesh, "dp") > 1:
            self._rows = slots // axis_size(mesh, "dp")
            self._row0 = axis_rank(mesh, "dp") * self._rows
        # Block-pressure deferrals (always empty on the dense pool).
        self._overflow: collections.deque = collections.deque()
        if self.paged:
            if max_seq % self.page_size:
                raise ValueError(f"max_seq {max_seq} must be a multiple of "
                                 f"page_size {self.page_size}")
            self._max_pages = max_seq // self.page_size
            if int(paged_blocks) < 1 + self._max_pages:
                raise ValueError(
                    f"paged_blocks={paged_blocks} cannot hold one "
                    f"max-length request plus the trash block (need >= "
                    f"{1 + self._max_pages})"
                )
            self.paged_blocks = int(paged_blocks)
            self._pool = BlockPool(self.paged_blocks)
            self._pages = np.zeros((slots, self._max_pages), np.int32)
            cache = self.engine.empty_pool(self.paged_blocks,
                                           self.page_size)
        else:
            cache = self.engine.empty_cache(self._rows)
        # Block-granular prefix sharing: base model, non-MoE only.
        self._paged_share = self.paged and bool(prefix_cache) and not cfg.moe

        i32 = dict(dtype=torch.int32, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        rows = self._rows
        self._dev = {
            "cache": cache,
            "token": torch.zeros(rows, **i32),
            "pos": torch.zeros(rows, **i32),      # cache position
            "rope": torch.zeros(rows, **i32),     # RoPE position
            "start": torch.zeros(rows, **i32),    # kv_start (left pad)
            "temps": torch.zeros(rows, **f32),
            "top_p": torch.zeros(rows, **f32),
            "aidx": torch.zeros(rows, **i32),     # adapter
            "cidx": torch.zeros(rows, **i32),     # constraint
            "cstate": torch.zeros(rows, **i32),   # its DFA state
        }
        if self.draft_engine is not None:
            # The draft's cache stays dense at the draft's dtype, even on
            # a paged or int8-KV target; prev is the stream token at
            # pos - 1 (the draft stays one position behind).
            self._dev["d_cache"] = self.draft_engine.empty_cache(rows)
            self._dev["prev"] = torch.zeros(rows, **i32)
        if self.spec_mode == "ngram":
            # hist[slot, p]: the stream token at position p, -1 unwritten.
            self._dev["hist"] = torch.full((rows, max_seq), -1, **i32)
        # Speculative telemetry (live rows only) and adaptive K: the window
        # resizes from the pooled rolling acceptance (_adaptive_k).
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_recent: collections.deque = collections.deque(maxlen=64)
        self._spec_k_active = self.spec_k
        self._spec_freeze = 0
        # The n-gram gate (scheduler._spec_gate), under the reference's
        # names: the acceptance floor, proposals a slot before it gates,
        # seconds between timed rounds of each mode, the probe base while
        # gated; then its state.
        self.ngram_breakeven = 0.125
        self.ngram_min_obs = 64
        self.ngram_measure_s = 5.0
        self.ngram_probe_s = 10.0
        self._ngram_next_meas = {"plain": 0.0, "spec": 0.0}
        self._ngram_timed_sched = {"plain": 0, "spec": 0}
        self._ngram_timed_rec = {"plain": 0, "spec": 0}
        self._ngram_probe_scale = 1
        self._ngram_fallback_rounds = 0
        self._gate_fallback = False
        self._slot_spec: dict[int, collections.deque] = {}
        self._mode_rate: dict[str, collections.deque] = {
            "spec": collections.deque(maxlen=4),
            "plain": collections.deque(maxlen=4),
        }
        if self.spec_mode == "neural":
            # Decode streams every weight byte once a step, so an int8
            # draft costs half a bf16 one per element.
            self._draft_ratio = (quantized_bytes(self.draft_params)[0]
                                 / max(1, quantized_bytes(params)[0]))
        else:
            # The n-gram draft has no forward: only the wider verify.
            self._draft_ratio = 0.02
        # Dense prefix-entry cache: prompt-prefix bytes -> a prefilled
        # [L, 1, KH, max_seq, ...] row, its last logits and its length.
        # Read-only once inserted; LRU-bounded (each entry owns a row of
        # device memory).  prefix_cache=False turns off both prefix
        # planes (this cache's lookups and block sharing).
        self.prefix_cache = bool(prefix_cache)
        self._prefix: collections.OrderedDict = collections.OrderedDict()
        self._prefix_cap = 4
        self._prefix_lock = threading.Lock()
        # Host mirrors of this rank's rows' sampling state.
        self._temps = [0.0] * rows
        self._gens: list = [None] * rows

        self._active: list = [None] * slots
        self.max_pending = max(0, int(max_pending))
        self._pending: queue.Queue = queue.Queue(maxsize=self.max_pending)
        self._dead = False
        # Serializes submit() against the end-of-life drain.
        self._lifecycle = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        # Quiesce barriers (run_quiesced): thunks the scheduler runs with
        # no round in flight; queued under _lifecycle like _pending.
        self._barriers: queue.Queue = queue.Queue()
        self._round_count = 0
        self._warmed = False
        # Admissions by path (the scheduler's module docstring lists the
        # names): shows which requests reused a prefix.
        self.admission_paths: collections.Counter = collections.Counter()
        # Device work dispatched: plain decode steps and speculative
        # verify sub-rounds (each one target forward over every slot).
        self.dispatched: collections.Counter = collections.Counter()
        self._seam = None
        self._thread_error = None
        if mesh is not None:
            from .meshed import Seam

            self._seam = Seam(self, mesh)
            self._seam.observe(self.metrics)
        self._thread = threading.Thread(
            target=self._run, name="continuous-batcher", daemon=True
        )

    def _run(self) -> None:
        # Autograd state is per thread: the scheduler thread needs its own.
        with torch.inference_mode():
            try:
                if self.is_leader:
                    self._loop()
                else:
                    self._seam.follow()
            except BaseException as e:
                self._thread_error = e
                raise
            finally:
                if self._seam is not None:
                    self._seam.unobserve()
