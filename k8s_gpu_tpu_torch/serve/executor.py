"""Device work of the continuous batcher: the port of
``k8s_gpu_tpu/serve/executor.py`` for both pools (``_first_token``,
``_constrained_first``, ``_seat``, ``_admit_dev``, ``_admit_round_dev``,
``_admit_prefix_dev``, ``_admit_exact_dev``, ``_admit_paged_dev``,
``_round_dev``) and the speculative rounds (``ngram_propose``,
``_spec_accept``, ``_round_spec_dev``, ``_round_spec_ngram_dev``).

Decode state lives on the device (``self._dev``) and is updated in place;
nothing here waits for the device, so the scheduler can queue a round
while the previous one runs.  A row's state is its next token, its cache
position ``pos``, its RoPE position ``rope`` and its first visible cache
slot ``start`` (``kv_start``): a left-padded admission seats
``pos = bucket``, ``rope = bucket - pad``, ``start = pad``.

Adapters and constraints (``ContinuousBatcher(adapters=...,
constraints=...)``): each row also carries its adapter ``aidx`` (0 the
base model), its constraint ``cidx`` (0 free) and its DFA state
``cstate``.  Every forward of a row passes the bank and the rows'
``aidx``; every token of a constrained row is taken from logits masked
by ``allowed[cidx, cstate]``, and ``cstate`` advances by ``next[cidx,
cstate, token]`` on the device.  A row with no allowed token (a dead
end) emits ``eos_id`` (0 without one) with a log-prob of 0, its state
held; the masked row is never sampled from (a softmax over -inf is NaN).

Sampling draws from a ``torch.Generator`` per slot, seeded with the
request's ``seed`` at admission: the same seed gives the same stream, but
not the reference's ``jax.random`` draws, so sampled streams compare with
the reference by distribution only.

Speculative state (``ContinuousBatcher(draft=...)``): a neural draft keeps
its own dense cache ``d_cache`` [L, slots, KH, max_seq, Dh] at the draft's
dtype (dense even on a paged or int8-KV target) and ``prev``, the stream
token at ``pos - 1``; the n-gram draft keeps ``hist`` [slots, max_seq],
the stream token at each position (-1 unwritten).  Every admission path
seats them: a cold admission prefills the draft on the same padded shape,
every other path zeroes the draft row, and the history holds the prompt
at its cache positions.

On a serving mesh every rank runs these methods on its own shards (the
leader's descriptor of each call, ``meshed.py``).  The dense pool cuts
its rows over dp: a rank holds the ``_rows`` slots from ``_row0`` on,
its state arrays index them locally (``_local``), an admission to a
slot of another dp group does nothing here, and ``meshed.py`` collects
the first token and the rounds' tokens over dp.  The paged pool stays
whole on every dp group, which runs every row.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..parallel.mesh import axis_rank, axis_size
from .engine import gumbel_sample, nucleus_mask
from .speculative import reject_row


def _write_dropped(hist, cols, vals) -> None:
    """hist[b, cols[b]] = vals[b] in place, dropped where cols[b] >= S
    (a scatter's out-of-range rule)."""
    S = hist.shape[1]
    at = cols.long().clamp(0, S - 1)[:, None]
    hist.scatter_(1, at, torch.where((cols < S)[:, None],
                                     vals[:, None].to(hist.dtype),
                                     hist.gather(1, at)))


def ngram_propose(hist, token, pos, k: int, m: int = 3):
    """Prompt-lookup proposals for a batch of rows: for each row, the most
    recent earlier position whose trailing m..1-gram matches the stream's
    current trailing gram, and the ``k`` tokens that followed it.

    ``hist`` [B, S] int32 is each row's token history (-1 unwritten) and
    ``token`` [B] the stream token at ``pos`` [B].  The winner is the
    argmax of ``matched_len * S + position``; no match, or a proposal
    running into unwritten history, repeats ``token``.  Index rules are
    the reference's: the write of ``token`` at ``pos`` is dropped past S,
    reads clamp into [0, S), and the proposal slice reads a history
    extended by k unwritten positions.  Proposals are hints: the verify
    accepts or corrects each one."""
    B, S = hist.shape
    dev = hist.device
    pos = pos.long()
    token = token.to(hist.dtype)
    hist = hist.clone()
    _write_dropped(hist, pos, token)
    idx = torch.arange(S, device=dev)
    score = torch.zeros(B, S, dtype=torch.int64, device=dev)
    run = torch.ones(B, S, dtype=torch.bool, device=dev)
    for u in range(m):
        shifted = torch.cat([hist.new_full((B, u + 1), -2),
                             hist[:, :S - u - 1]], dim=1)
        suffix = hist.gather(1, (pos - u).clamp(0, S - 1)[:, None])
        run = run & (shifted == suffix) & (suffix >= 0)
        score = score + run.long()
    score = torch.where(idx[None] <= pos[:, None], score, 0)
    j = torch.argmax(score * S + idx[None], dim=1)
    ext = torch.cat([hist, hist.new_full((B, k), -1)], dim=1)
    g = ext.gather(1, j[:, None] + torch.arange(k, device=dev)[None])
    best = score.gather(1, j[:, None])
    return torch.where((best > 0) & (g >= 0), g, token[:, None])


def _write_window_clamped(hist, start, vals) -> None:
    """hist[b, s:s + W] = vals[b] in place with s = start[b] clamped into
    [0, S - W], as ``dynamic_update_slice`` clamps: a row within W of the
    end writes backwards over older history."""
    S, W = hist.shape[1], vals.shape[1]
    s = start.long().clamp(0, S - W)[:, None]
    hist.scatter_(1, s + torch.arange(W, device=hist.device)[None],
                  vals.to(hist.dtype))


class ExecutorMixin:
    """Prefill/decode half of ``ContinuousBatcher``; its one host-side
    policy is the role gate."""

    def _guard_decode(self) -> None:
        """Refuse a decode round on a prefill-only executor: its
        requests retire at admission, so reaching a round is a role
        violation, and its pages may already have been handed over."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-only executor: decode round dispatch refused")

    def _first_token(self, logits, temp: float, gen, top_p: float,
                     mask=None, dead_tok: int = 0):
        """logits [V] f32 -> (token, logprob) as 0-d device tensors: the
        argmax when ``temp`` is 0, else a draw from the temperature-scaled,
        nucleus-masked distribution.  The logprob is the chosen token's
        under the unscaled (masked) distribution.  ``mask`` [V] bool:
        disallowed logits go to -inf; with nothing allowed the token is
        ``dead_tok`` and its logprob 0."""
        any_ok = None
        if mask is not None:
            any_ok = mask.any()
            logits = torch.where(mask, logits, -torch.inf)
        if temp > 0:
            # A dead row's logits are all -inf: draw from zeros instead.
            src = logits if any_ok is None else torch.where(any_ok, logits,
                                                            0.0)
            scaled = nucleus_mask(src / max(temp, 1e-6), top_p)
            first = gumbel_sample(scaled, gen)
        else:
            first = torch.argmax(logits)
        if any_ok is not None:
            first = torch.where(any_ok, first, dead_tok)
        lp = torch.log_softmax(logits.float(), dim=-1)[first]
        if any_ok is not None:
            lp = torch.where(any_ok, lp, 0.0)
        return first.to(torch.int32), lp

    def _ctab(self):
        """The constraint bank when it holds real patterns, else None."""
        cb = self.cbank
        return cb if cb is not None and cb.banked is not None else None

    def _bank_args(self, aidx):
        """The engine's adapter keywords for rows whose adapters are
        ``aidx`` (a [B] tensor, or a host int for one row)."""
        if self.bank.banked is None:
            return {}
        if not torch.is_tensor(aidx):
            aidx = torch.full((1,), int(aidx), dtype=torch.int32,
                              device=self.device)
        return {"adapters": self.bank.banked, "adapter_idx": aidx}

    def _constrained_first(self, logits, temp: float, gen, top_p: float,
                           cidx: int):
        """First-token sampling under the constraint bank: mask at the
        start state (0), then advance the DFA by the chosen token.
        Returns (token, logprob, cstate); cstate is 0 without a bank."""
        ctab = self._ctab()
        if ctab is None:
            first, lp = self._first_token(logits, temp, gen, top_p)
            return first, lp, 0
        mask = ctab.allowed[cidx, 0]
        first, lp = self._first_token(logits, temp, gen, top_p, mask,
                                      self.eos_id if self.eos_id >= 0 else 0)
        cstate = torch.where(mask.any(), ctab.next_state[cidx, 0,
                                                         first.long()], 0)
        return first, lp, cstate.to(torch.int32)

    def _local(self, slot: int):
        """``slot``'s index among this rank's rows, or None when another
        dp group holds it."""
        i = slot - self._row0
        return i if 0 <= i < self._rows else None

    def _elsewhere(self):
        """What an admission to another dp group's slot returns here: a
        zero token and log-prob, which the dp sum over the groups
        leaves as the owner's."""
        return (torch.zeros((), dtype=torch.int32, device=self.device),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def _slot_row(self, slot: int) -> dict:
        """The dense pool's row of ``slot`` as [L, 1, KH, max_seq, ...]
        views: writes into it land in the pool."""
        i = self._local(slot)
        return {name: arr[:, i:i + 1]
                for name, arr in self._dev["cache"].items()}

    def _splice_dense(self, row: dict, slot: int) -> None:
        """Copy a [L, 1, KH, T, ...] row into the dense pool's ``slot``.
        The reference's ``dynamic_update_slice`` clamps its start; slicing
        does not, so the slot and the row's length are checked."""
        if not 0 <= slot < self.slots:
            raise IndexError(f"slot {slot} outside [0, {self.slots})")
        i = self._local(slot)
        for name, arr in self._dev["cache"].items():
            if row[name].shape[3] != arr.shape[3]:
                raise ValueError(f"row of {row[name].shape[3]} positions "
                                 f"for a pool of {arr.shape[3]}")
            arr[:, i:i + 1].copy_(row[name])

    def _splice_paged(self, row: dict, page_row, n_copy: int) -> None:
        """Scatter the first ``n_copy`` positions of a [L, 1, KH, T, ...]
        row into the blocks ``page_row`` [MP] names, page by page: the
        same address math as ``engine._paged_store`` (block
        ``page_row[p // page]``, offset ``p % page``)."""
        page = self.page_size
        if n_copy > min(page_row.shape[0] * page,
                        next(iter(row.values())).shape[3]):
            raise ValueError(f"{n_copy} positions do not fit the row or "
                             "its page table")
        q_pos = torch.arange(n_copy, device=self.device)
        blk = page_row[q_pos // page].long()
        off = q_pos % page
        for name, arr in self._dev["cache"].items():
            chunk = row[name][:, 0, :, :n_copy]      # [L, KH, n, ...]
            arr[:, blk, :, off] = chunk.movedim(2, 0).to(arr.dtype)

    def _draft_row(self, slot: int) -> dict:
        """The draft cache's row of ``slot`` as [L, 1, KH, max_seq, ...]
        views."""
        i = self._local(slot)
        return {name: arr[:, i:i + 1]
                for name, arr in self._dev["d_cache"].items()}

    def _seat(self, slot: int, first, pos: int, rope: int, start: int,
              temp: float, top_p: float, gen, spec=None,
              draft_ready: bool = False, aidx: int = 0, cidx: int = 0,
              cstate=0) -> None:
        """Seat a slot's decode state; its K/V are already in the pool.
        ``aidx``, ``cidx``, ``cstate``: the row's adapter, constraint and
        DFA state.
        ``spec``: (prev, hist_row) from ``_spec_seat`` (None when spec is
        off): the last prompt token, re-ingested at pos - 1 each spec
        round, and the n-gram history with the prompt at its positions
        (None for a neural draft).  The draft row is zeroed unless the
        admission prefilled it (``draft_ready``): a previous tenant's
        draft K/V would poison this request's proposals."""
        dev = self._dev
        slot = self._local(slot)
        dev["token"][slot] = first
        dev["pos"][slot] = pos
        dev["rope"][slot] = rope
        dev["start"][slot] = start
        dev["temps"][slot] = temp
        dev["top_p"][slot] = top_p
        dev["aidx"][slot] = aidx
        dev["cidx"][slot] = cidx
        dev["cstate"][slot] = cstate
        self._temps[slot] = temp
        self._gens[slot] = gen
        if spec is None:
            return
        prev, hist_row = spec
        if self.draft_engine is not None:
            if not draft_ready:
                for arr in dev["d_cache"].values():
                    arr[:, slot].zero_()
            dev["prev"][slot] = prev
        if hist_row is not None:
            dev["hist"][slot] = hist_row
            dev["hist"][slot, pos] = first

    def _admit_dev(self, padded, slot: int, temp: float, seed: int,
                   pad: int, top_p: float, page_row=None, spec=None,
                   aidx: int = 0, cidx: int = 0):
        """Prefill one left-padded request on [1, bucket] and seat it at
        ``slot``.  Dense pool: the prefill writes the slot's row in place
        (zeroed first, as the reference's fresh row is).  Paged pool: it
        writes a row of ``bucket`` positions that splices into the
        slot's blocks.  The row's geometry is pos = bucket, rope =
        bucket - pad, start = pad.  A neural draft is prefilled on the
        same padded shape into its own row.  The prompt runs under the
        row's adapter (``aidx``)."""
        if self._local(slot) is None:
            return self._elsewhere()
        bucket = padded.shape[1]
        bank = self._bank_args(aidx)
        if page_row is None:
            _, last = self.engine.prefill(self.params, padded, pad,
                                          cache=self._slot_row(slot), **bank)
        else:
            row = self.engine.empty_cache(1, bucket)
            row, last = self.engine.prefill(self.params, padded, pad,
                                            cache=row, **bank)
            self._splice_paged(row, page_row, bucket)
        if spec is not None and self.draft_engine is not None:
            self.draft_engine.prefill(self.draft_params, padded, pad,
                                      cache=self._draft_row(slot))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp, cstate = self._constrained_first(last[0], temp, gen,
                                                    top_p, cidx)
        self._seat(slot, first, bucket, bucket - pad, pad, temp, top_p, gen,
                   spec, draft_ready=True, aidx=aidx, cidx=cidx,
                   cstate=cstate)
        return first, lp

    def _admit_round_dev(self, padded, slot: int, temp: float, seed: int,
                         pad: int, top_p: float, use_top_p: bool,
                         n_steps: int, t_hi: int, aidx: int = 0,
                         cidx: int = 0):
        """The fused cold start: ``_admit_dev`` then one ``_round_dev``,
        queued back to back with no host fetch between them.  The slot's
        generator takes the admission's draw, then the round's, as on the
        unfused path, so the stream is the same."""
        first, lp = self._admit_dev(padded, slot, temp, seed, pad, top_p,
                                    aidx=aidx, cidx=cidx)
        toks, lps = self._round_dev(use_top_p, n_steps, t_hi, None)
        return first, lp, toks, lps

    def _admit_prefix_dev(self, entry: dict, suffix, n_real: int,
                          slot: int, temp: float, seed: int, base_pos: int,
                          top_p: float, spec=None, cidx: int = 0):
        """Admit on a cached prefix (dense pool): splice the entry's row
        into the slot, then extend it with the right-padded suffix [1, W]
        in place.  Pad K/V land past the live length, where decode
        overwrites them and masks never read them; the entry itself is
        left as it was.  Entries hold base-model K/V: base rows only."""
        if self._local(slot) is None:
            return self._elsewhere()
        self._splice_dense(entry["cache"], slot)
        base = torch.full((1,), base_pos, dtype=torch.int32,
                          device=self.device)
        _, logits = self.engine.extend_multi(
            self.params, self._slot_row(slot), suffix, base, base,
            torch.zeros_like(base),
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp, cstate = self._constrained_first(
            logits[0, n_real - 1], temp, gen, top_p, cidx)
        pos = base_pos + n_real
        self._seat(slot, first, pos, pos, 0, temp, top_p, gen, spec,
                   cidx=cidx, cstate=cstate)
        return first, lp

    def _admit_exact_dev(self, row: dict, logits, pos: int, rope: int,
                         start: int, slot: int, temp: float, seed: int,
                         top_p: float, spec=None, aidx: int = 0,
                         cidx: int = 0, page_row=None):
        """Seat a row whose K/V were computed elsewhere: splice and sample
        from ``logits`` [1, V], no model forward.  Two callers: a prompt
        that is a cached prefix (dense pool; pos = rope = n, start = 0)
        and a disaggregated handover (``submit_precomputed``, either
        pool), whose geometry comes with the row.  On the paged pool the
        row's first ``pos`` positions splice into the blocks ``page_row``
        names."""
        if self._local(slot) is None:
            return self._elsewhere()
        row = self._rank_heads(row)
        if page_row is None:
            self._splice_dense(row, slot)
        else:
            self._splice_paged(row, page_row, pos)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp, cstate = self._constrained_first(logits[0], temp, gen,
                                                    top_p, cidx)
        self._seat(slot, first, pos, rope, start, temp, top_p, gen, spec,
                   aidx=aidx, cidx=cidx, cstate=cstate)
        return first, lp

    def _rank_heads(self, row: dict) -> dict:
        """A [L, 1, KH, ...] row at this rank's KV heads: a whole row
        (a handover prefilled off the mesh) is cut to its tp slice."""
        if next(iter(row.values())).shape[2] == self.engine.kv_heads:
            return row
        tp, r = axis_size(self.mesh, "tp"), axis_rank(self.mesh, "tp")
        return {name: t.chunk(tp, dim=2)[r] for name, t in row.items()}

    def _drop_held_dev(self, row: dict) -> None:
        """A precomputed row that will not be seated: the call's
        descriptor took each follower's rows of it (``meshed.HeldRow``),
        and they go with it."""

    def _admit_entry_dev(self, entry: dict, slot: int, temp: float,
                         seed: int, top_p: float, spec=None, cidx: int = 0):
        """A prompt that is exactly a cached prefix entry (dense pool):
        ``_admit_exact_dev`` on the entry's row and logits."""
        n = entry["n"]
        return self._admit_exact_dev(entry["cache"], entry["logits"], n, n,
                                     0, slot, temp, seed, top_p, spec,
                                     cidx=cidx)

    def _prefix_dev(self, key: bytes, padded, n: int, evict=()) -> None:
        """Prefill a prefix entry (dense pool): a right-padded
        ``extend_multi`` over ``padded`` [1, W] on a fresh row, kept under
        ``key`` with its logits at the last of its ``n`` tokens; the
        entries ``evict`` names go first (the caller keeps the LRU
        order)."""
        zero = torch.zeros(1, dtype=torch.int32, device=self.device)
        cache, logits = self.engine.extend_multi(
            self.params, self.engine.empty_cache(1), padded, zero, zero,
            zero)
        with self._prefix_lock:
            for old in evict:
                self._prefix.pop(old, None)
            self._prefix[key] = {"cache": cache, "logits": logits[:, n - 1],
                                 "n": n, "key": key}
            self._prefix.move_to_end(key)

    def _admit_paged_dev(self, suffix, n_real: int, slot: int, temp: float,
                         seed: int, base_pos: int, top_p: float, page_row,
                         spec=None, cidx: int = 0):
        """Extend the slot's page-table row with the right-padded suffix
        [1, W], writing K/V straight into the pool.  ``base_pos`` tokens
        of shared prefix are already resident in the blocks the row names
        first (0 on a cold miss); the extend's writes land at positions >=
        base_pos, in the request's private tail blocks, so shared blocks
        stay read-only.  Right-pad K/V land past the live length (decode
        overwrites them, masks never read them) or in the trash block."""
        i32 = dict(dtype=torch.int32, device=self.device)
        base = torch.full((1,), base_pos, **i32)
        _, logits = self.engine.extend_multi(
            self.params, self._dev["cache"], suffix, base, base,
            torch.zeros(1, **i32), pages=page_row[None], page=self.page_size,
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp, cstate = self._constrained_first(
            logits[0, n_real - 1], temp, gen, top_p, cidx)
        pos = base_pos + n_real
        self._seat(slot, first, pos, pos, 0, temp, top_p, gen, spec,
                   cidx=cidx, cstate=cstate)
        return first, lp

    @torch.no_grad()
    def _round_dev(self, use_top_p: bool, n_steps: int, t_hi: int, pages):
        """``n_steps`` batched decode steps over every slot, each row at
        its own cache position, RoPE position and ``kv_start``.  ``pages``
        [slots, MP]: the paged pool's tables; None on the dense pool.
        Returns (tokens [T, B] int32, logprobs [T, B] f32) on the device.
        Rows past their budget or retired compute tokens nobody reads.
        An n-gram batcher's history takes each token at pos + 1 here too
        (dropped past max_seq), so a probe after plain rounds proposes
        from real history.  With a constraint bank each step masks every
        row by ``allowed[cidx, cstate]`` and advances ``cstate`` (module
        docstring); with an adapter bank every row reads its adapter."""
        dev = self._dev
        token, pos, rope = dev["token"], dev["pos"], dev["rope"]
        cstate, cidx = dev["cstate"], dev["cidx"].long()
        ctab = self._ctab()
        bank = self._bank_args(dev["aidx"])
        dead = self.eos_id if self.eos_id >= 0 else 0
        sampled = [i for i, t in enumerate(self._temps) if t > 0]
        rows = torch.arange(self._rows, device=self.device)
        toks, lps = [], []
        for _ in range(n_steps):
            _, logits = self.engine.decode_step_multi(
                self.params, dev["cache"], token, pos, rope, dev["start"],
                t_hi=t_hi, pages=pages, page=self.page_size, **bank,
            )
            if ctab is not None:
                mask = ctab.allowed[cidx, cstate.long()]          # [B, V]
                logits = torch.where(mask, logits, -torch.inf)
                any_ok = mask.any(-1)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if sampled:
                # Dead rows draw from zeros (all -inf would give NaN).
                src = (logits if ctab is None
                       else torch.where(any_ok[:, None], logits, 0.0))
                scaled = self._warp(src, use_top_p)
                for i in sampled:
                    nxt[i] = gumbel_sample(scaled[i], self._gens[i])
            if ctab is not None:
                nxt = torch.where(any_ok, nxt, dead)
                cstate = torch.where(
                    any_ok, ctab.next_state[cidx, cstate.long(), nxt.long()],
                    cstate)
            if self.collect_logprobs:
                lsm = torch.log_softmax(logits.float(), dim=-1)
                lp = lsm[rows, nxt.long()]
                if ctab is not None:
                    lp = torch.where(any_ok, lp, 0.0)
            else:
                lp = torch.zeros(self._rows, device=self.device)
            if self.spec_mode == "ngram":
                _write_dropped(dev["hist"], pos + 1, nxt)
            toks.append(nxt)
            lps.append(lp)
            token, pos, rope = nxt, pos + 1, rope + 1
        dev.update(token=token, pos=pos, rope=rope, cstate=cstate)
        return torch.stack(toks), torch.stack(lps)

    def _warp(self, logits, use_top_p: bool):
        """Each row's sampling warp: logits [B, ..., V] over its
        temperature, then its nucleus when any row asks for one (rows
        whose top_p is off come back unchanged)."""
        dev = self._dev
        extra = (1,) * (logits.dim() - 2)
        scaled = (logits.float()
                  / dev["temps"].clamp_min(1e-6).view(-1, *extra, 1))
        if use_top_p:
            top_p = dev["top_p"].view(-1, *extra).expand(scaled.shape[:-1])
            scaled = nucleus_mask(scaled, top_p)
        return scaled

    def _spec_accept(self, vlogits, g, q, use_top_p: bool):
        """The verify/accept/advance math of both spec rounds.  ``vlogits``
        [B, K+1, V]: the target's logits over each row's [token, g]
        window; ``g`` [B, K] the proposals; ``q`` [B, K, V] the warped
        distributions they were drawn from (a one-hot for the n-gram
        draft), read for sampled rows only (None when there are none).
        Greedy rows accept the longest prefix of ``g`` matching the
        target's argmax and emit the argmax after it; sampled rows run
        ``reject_row`` on their own generator.  Returns (e [B, K+1] the
        emitted window, n [B] = accepted + 1, logprobs [B, K+1], a [B],
        the next feed [B]).  ``spec_draft``, ``spec_verify`` and
        ``spec_accept`` label a sub-round's three parts for
        ``torch.profiler``."""
        with record_function("spec_accept"):
            B, K = g.shape
            t_pred = torch.argmax(vlogits, dim=-1).to(torch.int32)
            match = (g == t_pred[:, :K]).to(torch.int32)
            a = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
            corr = t_pred
            sampled = [i for i, t in enumerate(self._temps) if t > 0]
            if sampled:
                p = torch.softmax(self._warp(vlogits, use_top_p), dim=-1)
                corr = t_pred.clone()
                for i in sampled:
                    a_i, x_i = reject_row(p[i], q[i], g[i], self._gens[i])
                    a[i] = a_i
                    corr[i] = x_i
            idx = torch.arange(K + 1, device=g.device)[None]
            base = torch.cat([g, g[:, -1:]], dim=1)
            e = torch.where(idx < a[:, None], base, corr)
            if self.collect_logprobs:
                lsm = torch.log_softmax(vlogits.float(), dim=-1)
                lp = lsm.gather(2, e.long()[..., None])[..., 0]
            else:
                lp = torch.zeros(B, K + 1, device=g.device)
            new_token = e.gather(1, a.long()[:, None])[:, 0]
            return e, a + 1, lp, a, new_token

    def _verify(self, window, pos, rope, t_hi: int, pages):
        """One target forward over every row's [token, g] window: on the
        paged pool with ``attn_impl="paged_kernel"`` one kernel launch a
        layer at Sq = K + 1."""
        with record_function("spec_verify"):
            _, vlogits = self.engine.extend_multi(
                self.params, self._dev["cache"], window, pos, rope,
                self._dev["start"], t_hi=t_hi, pages=pages,
                page=self.page_size, **self._bank_args(self._dev["aidx"]),
            )
        return vlogits

    @torch.no_grad()
    def _round_spec_dev(self, use_top_p: bool, n_rounds: int, t_hi: int,
                        K: int, pages):
        """``n_rounds`` speculative sub-rounds over every slot, each K
        draft steps and one target verify.  Returns (toks [R, B, K+1], ns
        [R, B], lps [R, B, K+1]): row b emitted ns[r, b] tokens in
        sub-round r.  Greedy rows are the plain stream exactly; sampled
        rows are exact in distribution.  Retired rows advance as garbage;
        their writes past max_seq are dropped and nothing of them is
        emitted."""
        dev = self._dev
        kv_start = dev["start"]
        d_eng, dparams = self.draft_engine, self.draft_params
        sampled = [i for i, t in enumerate(self._temps) if t > 0]
        token, prev = dev["token"], dev["prev"]
        pos, rope = dev["pos"], dev["rope"]
        toks, ns, lps = [], [], []
        for _ in range(n_rounds):
            # 1. Re-ingest prev at pos - 1 (an idempotent overwrite that
            #    also warms a zero-seated row), then K lookahead steps.
            with record_function("spec_draft"):
                d_eng.decode_step_multi(
                    dparams, dev["d_cache"], prev,
                    torch.maximum(pos - 1, kv_start),
                    (rope - 1).clamp_min(0), kv_start, t_hi=t_hi)
                tok, drafts, qs = token, [], []
                for i in range(K):
                    _, dlogits = d_eng.decode_step_multi(
                        dparams, dev["d_cache"], tok, pos + i, rope + i,
                        kv_start, t_hi=t_hi)
                    tok = torch.argmax(dlogits, dim=-1).to(torch.int32)
                    if sampled:
                        dscaled = self._warp(dlogits, use_top_p)
                        for r in sampled:
                            tok[r] = gumbel_sample(dscaled[r],
                                                   self._gens[r])
                        qs.append(torch.softmax(dscaled, dim=-1))
                    drafts.append(tok)
                g = torch.stack(drafts, dim=1)                   # [B, K]
            # 2. Verify: one target forward over the [token, g] windows.
            window = torch.cat([token[:, None], g], dim=1)
            vlogits = self._verify(window, pos, rope, t_hi, pages)
            # 3. Accept or correct.
            e, n, lp, a, token = self._spec_accept(
                vlogits, g, torch.stack(qs, dim=1) if sampled else None,
                use_top_p)
            # 4. Advance: window[a] sits at the new pos - 1.
            prev = window.gather(1, a.long()[:, None])[:, 0]
            pos, rope = pos + n, rope + n
            toks.append(e)
            ns.append(n)
            lps.append(lp)
        dev.update(token=token, prev=prev, pos=pos, rope=rope)
        return torch.stack(toks), torch.stack(ns), torch.stack(lps)

    @torch.no_grad()
    def _round_spec_ngram_dev(self, use_top_p: bool, n_rounds: int,
                              t_hi: int, K: int, pages):
        """Speculative sub-rounds with the prompt-lookup draft: proposals
        from ``ngram_propose`` over each row's history, so a sub-round is
        one target verify and nothing else; the accept math is
        ``_spec_accept`` with a one-hot draft distribution.  The emitted
        window lands in the history at pos + 1, rejected positions
        included, clamped backwards within K + 1 of max_seq as the
        reference's ``dynamic_update_slice``; both only change proposal
        quality, never the stream."""
        dev = self._dev
        V = self.engine.cfg.vocab_size
        sampled = [i for i, t in enumerate(self._temps) if t > 0]
        hist = dev["hist"]
        token, pos, rope = dev["token"], dev["pos"], dev["rope"]
        toks, ns, lps = [], [], []
        for _ in range(n_rounds):
            with record_function("spec_draft"):
                g = ngram_propose(hist, token, pos, K).to(torch.int32)
            window = torch.cat([token[:, None], g], dim=1)
            vlogits = self._verify(window, pos, rope, t_hi, pages)
            q = (torch.nn.functional.one_hot(g.long(), V).float()
                 if sampled else None)
            e, n, lp, _, new_token = self._spec_accept(vlogits, g, q,
                                                       use_top_p)
            _write_window_clamped(hist, pos + 1, e)
            token, pos, rope = new_token, pos + n, rope + n
            toks.append(e)
            ns.append(n)
            lps.append(lp)
        dev.update(token=token, pos=pos, rope=rope)
        return torch.stack(toks), torch.stack(ns), torch.stack(lps)
