#!/usr/bin/env python3
"""Phase 4f of ``chip_smoke.py`` alone, and where its banks' time goes.

    python3 tools/torch_lifecycle_check.py [--profile] [--ab N]
                                           [--json PATH] [--device cuda]

Builds the paged and flash-v1 kernels, then runs
``chip_smoke.run_lifecycle_path`` on the flagship (bundles, the LoRA
fine-tune, multi-LoRA serving, constraints, the disaggregated prefill
pool; every check of the phase), with ``--profile`` the multi-LoRA and
constraint bursts profiled on their schedulers' threads beside their
bank-less yardsticks (launches and device ms a decode step, the kernels
the bank adds).  ``--ab N`` then serves phase 4f.4's bursts again through
a bank-less and a banked ``LmServer``, alternating, N times each (ms a
decode step), and profiles one burst of each for its largest host
operators.  Prints one JSON line per part and the card's name and power
limit first and last.  It runs on the card and raises where there is no
CUDA; ``--device cpu`` rehearses it at one layer on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def constraint_ab(torch, cs, layers: int, n: int, device) -> dict:
    """Phase 4f.4's bursts, bank-less then banked, ``n`` times each, then
    one profiled burst of each: host operators by self time."""
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.serve import LmServer, schema_to_regex

    cfg = cs.flagship_config(torch, layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(0)
    tok = cs.flagship_tokenizer(cfg.vocab_size)
    sync = cs._syncer(torch, model.device)
    patterns = {"date": cs.DATE_RE, "json": schema_to_regex(cs.JSON_SCHEMA)}
    rng = torch.Generator().manual_seed(30)
    names = ("date",) * 3 + ("json",) * 3 + (None, None)
    jobs = [(torch.randint(0, cfg.vocab_size, (40 + 8 * i,),
                           generator=rng).tolist(), cs.CONSTRAINT_NEW, c)
            for i, c in enumerate(names)]
    kw = dict(slots=8, paged_blocks=80, page_size=cs.PAGE,
              attn_impl="paged_kernel", eos_id=cs.CONSTRAINT_EOS,
              device=device)
    servers = {"bankless": LmServer(model, params, tok, **kw).start(),
               "bank": LmServer(model, params, tok, constraints=patterns,
                                **kw).start()}

    def bodies(label):
        return [{"prompt_ids": p, "max_new_tokens": m,
                 **({"constraint": c} if label == "bank" and c else {})}
                for p, m, c in jobs]

    out = {label: [] for label in servers}
    profiled = {}
    try:
        for label, srv in servers.items():      # warm both
            cs._served_burst(torch, srv, bodies(label), sync, layers,
                             device, False, False)
        for _ in range(n):
            for label, srv in servers.items():
                burst = cs._served_burst(torch, srv, bodies(label), sync,
                                         layers, device, False, False)
                out[label].append(burst["ms_per_decode_step"])
        for label, srv in servers.items():
            prof = cs._profile_batcher(torch, srv.batcher)
            sync()
            t0 = time.perf_counter()
            cs._stream_bodies(srv.port, bodies(label))
            sync()
            wall = time.perf_counter() - t0
            cs._stop_batcher_profile(srv.batcher, prof)
            host = sorted(
                ((e.self_cpu_time_total / 1e3, e.count, e.key[:90])
                 for e in prof.key_averages()
                 if not str(getattr(e, "device_type", "")).endswith("CUDA")),
                reverse=True)[:16]
            profiled[label] = {"wall_s": wall, "host_ms_top": host}
    finally:
        for srv in servers.values():
            srv.stop()
    return {"ms_per_decode_step": out, "profiled": profiled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--ab", type=int, default=0, metavar="N")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; --device cpu rehearses")
    layers = cs.LAYERS if on_card else 1
    gpu = cs.gpu_line() if on_card else "cpu"
    print(gpu, flush=True)
    if on_card:
        from concurrent.futures import ThreadPoolExecutor

        from k8s_gpu_tpu_torch.ops import _build

        with ThreadPoolExecutor(2) as pool:
            list(pool.map(_build.load,
                          ("paged_attention", "flash_attention")))
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {"gpu": gpu, "lifecycle": cs.run_lifecycle_path(
        torch, args.seed, layers, device=args.device, profile=args.profile,
        train_batch=cs.LORA_TRAIN_BATCH if on_card else 1)}
    if args.ab:
        result["constraint_ab"] = constraint_ab(torch, cs, layers, args.ab,
                                                args.device)
        print(json.dumps({"constraint_ab": result["constraint_ab"]}),
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
