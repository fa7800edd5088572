"""Device work of the continuous batcher: the port of
``k8s_gpu_tpu/serve/executor.py`` for both pools (``_first_token``,
``_seat``, ``_admit_dev``, ``_admit_round_dev``, ``_admit_prefix_dev``,
``_admit_exact_dev``, ``_admit_paged_dev``, ``_round_dev``).

Decode state lives on the device (``self._dev``) and is updated in place;
nothing here waits for the device, so the scheduler can queue a round
while the previous one runs.  A row's state is its next token, its cache
position ``pos``, its RoPE position ``rope`` and its first visible cache
slot ``start`` (``kv_start``): a left-padded admission seats
``pos = bucket``, ``rope = bucket - pad``, ``start = pad``.

Sampling draws from a ``torch.Generator`` per slot, seeded with the
request's ``seed`` at admission: the same seed gives the same stream, but
not the reference's ``jax.random`` draws, so sampled streams compare with
the reference by distribution only.
"""

from __future__ import annotations

import torch

from .engine import _empty_cache, gumbel_sample, nucleus_mask


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

    def _first_token(self, logits, temp: float, gen, top_p: float):
        """logits [V] f32 -> (token, logprob) as 0-d device tensors: the
        argmax when ``temp`` is 0, else a draw from the temperature-scaled,
        nucleus-masked distribution.  The logprob is the chosen token's
        under the unscaled distribution."""
        if temp > 0:
            scaled = nucleus_mask(logits / max(temp, 1e-6), top_p)
            first = gumbel_sample(scaled, gen)
        else:
            first = torch.argmax(logits)
        lp = torch.log_softmax(logits.float(), dim=-1)[first]
        return first.to(torch.int32), lp

    def _slot_row(self, slot: int) -> dict:
        """The dense pool's row of ``slot`` as [L, 1, KH, max_seq, ...]
        views: writes into it land in the pool."""
        return {name: arr[:, slot:slot + 1]
                for name, arr in self._dev["cache"].items()}

    def _splice_dense(self, row: dict, slot: int) -> None:
        """Copy a [L, 1, KH, T, ...] row into the dense pool's ``slot``.
        The reference's ``dynamic_update_slice`` clamps its start; slicing
        does not, so the slot and the row's length are checked."""
        if not 0 <= slot < self.slots:
            raise IndexError(f"slot {slot} outside [0, {self.slots})")
        for name, arr in self._dev["cache"].items():
            if row[name].shape[3] != arr.shape[3]:
                raise ValueError(f"row of {row[name].shape[3]} positions "
                                 f"for a pool of {arr.shape[3]}")
            arr[:, slot:slot + 1].copy_(row[name])

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

    def _seat(self, slot: int, first, pos: int, rope: int, start: int,
              temp: float, top_p: float, gen) -> None:
        """Seat a slot's decode state; its K/V are already in the pool."""
        dev = self._dev
        dev["token"][slot] = first
        dev["pos"][slot] = pos
        dev["rope"][slot] = rope
        dev["start"][slot] = start
        dev["temps"][slot] = temp
        dev["top_p"][slot] = top_p
        self._temps[slot] = temp
        self._gens[slot] = gen

    def _admit_dev(self, padded, slot: int, temp: float, seed: int,
                   pad: int, top_p: float, page_row=None):
        """Prefill one left-padded request on [1, bucket] and seat it at
        ``slot``.  Dense pool: the prefill writes the slot's row in place
        (zeroed first, as the reference's fresh row is).  Paged pool: it
        writes a row of ``bucket`` positions that splices into the
        slot's blocks.  The row's geometry is pos = bucket, rope =
        bucket - pad, start = pad."""
        bucket = padded.shape[1]
        if page_row is None:
            _, last = self.engine.prefill(self.params, padded, pad,
                                          cache=self._slot_row(slot))
        else:
            row = _empty_cache(self.engine.cfg, 1, bucket,
                               self.engine.kv_quant, self.device)
            row, last = self.engine.prefill(self.params, padded, pad,
                                            cache=row)
            self._splice_paged(row, page_row, bucket)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp = self._first_token(last[0], temp, gen, top_p)
        self._seat(slot, first, bucket, bucket - pad, pad, temp, top_p, gen)
        return first, lp

    def _admit_round_dev(self, padded, slot: int, temp: float, seed: int,
                         pad: int, top_p: float, use_top_p: bool,
                         n_steps: int, t_hi: int):
        """The fused cold start: ``_admit_dev`` then one ``_round_dev``,
        queued back to back with no host fetch between them.  The slot's
        generator takes the admission's draw, then the round's, as on the
        unfused path, so the stream is the same."""
        first, lp = self._admit_dev(padded, slot, temp, seed, pad, top_p)
        toks, lps = self._round_dev(use_top_p, n_steps, t_hi, None)
        return first, lp, toks, lps

    def _admit_prefix_dev(self, entry: dict, suffix, n_real: int,
                          slot: int, temp: float, seed: int, base_pos: int,
                          top_p: float):
        """Admit on a cached prefix (dense pool): splice the entry's row
        into the slot, then extend it with the right-padded suffix [1, W]
        in place.  Pad K/V land past the live length, where decode
        overwrites them and masks never read them; the entry itself is
        left as it was."""
        self._splice_dense(entry["cache"], slot)
        base = torch.full((1,), base_pos, dtype=torch.int32,
                          device=self.device)
        _, logits = self.engine.extend_multi(
            self.params, self._slot_row(slot), suffix, base, base,
            torch.zeros_like(base),
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp = self._first_token(logits[0, n_real - 1], temp, gen,
                                      top_p)
        pos = base_pos + n_real
        self._seat(slot, first, pos, pos, 0, temp, top_p, gen)
        return first, lp

    def _admit_exact_dev(self, entry: dict, slot: int, temp: float,
                         seed: int, top_p: float):
        """Seat a prompt that is a cached prefix (dense pool): splice the
        entry's row and sample from its logits, no model forward
        (pos = rope = n, start = 0)."""
        self._splice_dense(entry["cache"], slot)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, lp = self._first_token(entry["logits"][0], temp, gen, top_p)
        n = entry["n"]
        self._seat(slot, first, n, n, 0, temp, top_p, gen)
        return first, lp

    def _admit_paged_dev(self, suffix, n_real: int, slot: int, temp: float,
                         seed: int, base_pos: int, top_p: float, page_row):
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
        first, lp = self._first_token(logits[0, n_real - 1], temp, gen,
                                      top_p)
        pos = base_pos + n_real
        self._seat(slot, first, pos, pos, 0, temp, top_p, gen)
        return first, lp

    @torch.no_grad()
    def _round_dev(self, use_top_p: bool, n_steps: int, t_hi: int, pages):
        """``n_steps`` batched decode steps over every slot, each row at
        its own cache position, RoPE position and ``kv_start``.  ``pages``
        [slots, MP]: the paged pool's tables; None on the dense pool.
        Returns (tokens [T, B] int32, logprobs [T, B] f32) on the device.
        Rows past their budget or retired compute tokens nobody reads."""
        dev = self._dev
        token, pos, rope = dev["token"], dev["pos"], dev["rope"]
        temps = dev["temps"]
        sampled = [i for i, t in enumerate(self._temps) if t > 0]
        rows = torch.arange(self.slots, device=self.device)
        toks, lps = [], []
        for _ in range(n_steps):
            _, logits = self.engine.decode_step_multi(
                self.params, dev["cache"], token, pos, rope, dev["start"],
                t_hi=t_hi, pages=pages, page=self.page_size,
            )
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if sampled:
                scaled = logits / temps.clamp_min(1e-6)[:, None]
                if use_top_p:
                    scaled = nucleus_mask(scaled, dev["top_p"])
                for i in sampled:
                    nxt[i] = gumbel_sample(scaled[i], self._gens[i])
            if self.collect_logprobs:
                lsm = torch.log_softmax(logits.float(), dim=-1)
                lp = lsm[rows, nxt.long()]
            else:
                lp = torch.zeros(self.slots, device=self.device)
            toks.append(nxt)
            lps.append(lp)
            token, pos, rope = nxt, pos + 1, rope + 1
        dev.update(token=token, pos=pos, rope=rope)
        return torch.stack(toks), torch.stack(lps)
