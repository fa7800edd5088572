"""Device work of the continuous batcher: the port of
``k8s_gpu_tpu/serve/executor.py`` for paged-pool serving (``_first_token``,
``_seat``, ``_admit_paged_dev``, ``_round_dev``).

Decode state lives on the device (``self._dev``) and is updated in place;
nothing here waits for the device, so the scheduler can queue a round
while the previous one runs.  Sampling draws from a ``torch.Generator``
per slot, seeded with the request's ``seed`` at admission: the same seed
gives the same stream, but not the reference's ``jax.random`` draws, so
sampled streams compare with the reference by distribution only.
"""

from __future__ import annotations

import torch

from .engine import gumbel_sample, nucleus_mask


class ExecutorMixin:
    """Prefill/decode half of ``ContinuousBatcher``."""

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

    def _seat(self, slot: int, first, pos: int, temp: float, top_p: float,
              gen) -> None:
        """Seat a slot's decode state (the K/V already live in the pool,
        written through the slot's page-table row)."""
        dev = self._dev
        dev["token"][slot] = first
        dev["pos"][slot] = pos
        dev["temps"][slot] = temp
        dev["top_p"][slot] = top_p
        self._temps[slot] = temp
        self._gens[slot] = gen

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
        self._seat(slot, first, base_pos + n_real, temp, top_p, gen)
        return first, lp

    @torch.no_grad()
    def _round_dev(self, use_top_p: bool, n_steps: int, t_hi: int, pages):
        """``n_steps`` batched decode steps over every slot.  Returns
        (tokens [T, B] int32, logprobs [T, B] f32) on the device.  Rows
        past their budget or retired compute tokens nobody reads."""
        dev = self._dev
        token, pos = dev["token"], dev["pos"]
        temps = dev["temps"]
        sampled = [i for i, t in enumerate(self._temps) if t > 0]
        rows = torch.arange(self.slots, device=self.device)
        toks, lps = [], []
        for _ in range(n_steps):
            # Paged admissions never left-pad: a row's RoPE position is its
            # cache position and its visible range starts at 0.
            _, logits = self.engine.decode_step_multi(
                self.params, dev["cache"], token, pos, pos, dev["start"],
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
            token, pos = nxt, pos + 1
        dev.update(token=token, pos=pos)
        return torch.stack(toks), torch.stack(lps)
