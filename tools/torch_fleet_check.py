#!/usr/bin/env python3
"""Where a KV chain's migration time goes, stage by stage, on the card.

    python3 tools/torch_fleet_check.py [--layers 16] [--repeat 5]
                                       [--device cuda]

Builds the flagship of ``chip_smoke.py`` (random weights, bf16, the paged
pool of phase 4d: 72 blocks of 64, the paged kernel), serves one
512-token prefix plus 24 tokens so its 8 full pages are registered, then
times what ``/admin/export`` and ``/admin/import`` do with that chain,
each stage alone, ``--repeat`` times: the export's snapshot under the
quiesce barrier (one gather and copy to the host), ``pack`` (base64),
the server's ``json.dumps`` and the client's ``json.loads``; the
import's client ``json.dumps``, the server's ``json.loads``, ``unpack``
(base64 decode) and the splice under the barrier (one copy to the card
and one ``index_copy_`` a leaf) into a fresh pool.  Prints one JSON line
of milliseconds (min and median per stage) with the card's name and
power limit.  It runs on the card, and raises where there is no CUDA;
``--device cpu --layers 1`` rehearses it on the CPU (times of the CPU,
marked ``"gpu": "cpu"``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for a rehearsal")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from k8s_gpu_tpu_torch.device import resolve_device
    from k8s_gpu_tpu_torch.models import TransformerLM
    from k8s_gpu_tpu_torch.serve import ContinuousBatcher
    from k8s_gpu_tpu_torch.serve.migrate import pack, unpack
    from k8s_gpu_tpu_torch.utils.metrics import MetricsRegistry

    device = resolve_device(args.device)
    cfg = chip_smoke.flagship_config(torch, args.layers)
    model = TransformerLM(cfg, device=device)
    params = model.init(args.seed)

    def batcher():
        return ContinuousBatcher(
            model, params, slots=8, paged_blocks=chip_smoke.FLEET_BLOCKS,
            page_size=chip_smoke.PAGE, attn_impl="paged_kernel",
            metrics=MetricsRegistry(), device=device).start()

    rng = torch.Generator().manual_seed(args.seed)
    x = torch.randint(0, cfg.vocab_size, (536,), generator=rng).tolist()
    src = batcher()
    times: dict[str, list[float]] = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        times.setdefault(stage, []).append((time.perf_counter() - t0) * 1e3)
        return out

    try:
        src.submit(x, max_new_tokens=2).result()
        for _ in range(args.repeat):
            snap = timed("export_snapshot", lambda: src.run_quiesced(
                src.migrate_export))
            payload = timed("export_pack", lambda: pack(snap))
            body = timed("export_json_dumps", lambda: json.dumps(payload))
            got = timed("client_json_loads", lambda: json.loads(body))
            sent = timed("client_json_dumps", lambda: json.dumps(got))
            parsed_body = timed("import_json_loads", lambda: json.loads(sent))
            parsed = timed("import_unpack", lambda: unpack(parsed_body))
            dst = batcher()
            try:
                n = timed("import_splice", lambda: dst.run_quiesced(
                    lambda: dst.migrate_import(parsed)))
            finally:
                dst.stop()
            if n != len(payload["blocks"]):
                raise RuntimeError(f"imported {n} of "
                                   f"{len(payload['blocks'])} blocks")
    finally:
        src.stop()
    print(json.dumps({
        "gpu": chip_smoke.gpu_line() if device.type == "cuda" else "cpu",
        "layers": args.layers, "blocks": len(payload["blocks"]),
        "payload_mb": len(body) / 1e6,
        "ms": {stage: {"min": min(v), "median": statistics.median(v)}
               for stage, v in times.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
