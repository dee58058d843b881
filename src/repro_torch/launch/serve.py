"""Serving driver: ``python -m repro_torch.launch.serve [--requests N]``.

Stands up a ParetoBandit-routed portfolio of (SMOKE-sized)
architectures, one budget, one mid and one frontier arm, each priced from
its FULL architecture, and streams synthetic requests through the closed
loop via the serving gateway: requests enter in admission windows of
``--window``, feedback is applied by learner ticks every
``--publish-every`` windows, and the run ends with the gateway's
telemetry (Prometheus text with ``--prom``) plus an optional state
snapshot (``--snapshot PATH``, the JAX package's .npz + manifest). Runs
on ``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain
version).

The default trio is the JAX driver's: olmo-1b, mamba2-370m (an SSM),
deepseek-67b. ``--arch`` takes any of the ten ids of
``repro_torch.configs.ARCH_IDS``; whisper-medium's prefill needs encoder
frames that ``ServedModel.generate`` does not pass, so a request routed
to it raises ``ValueError`` (the JAX driver fails there too).
``--dry-run`` is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse

DEFAULT_ARCHS = ("olmo-1b", "mamba2-370m", "deepseek-67b")


def main(argv=None):
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--budget", type=float, default=6.6e-4)
    ap.add_argument("--arch", action="append", default=None,
                    choices=configs.ARCH_IDS,
                    help="portfolio member (repeatable); default "
                    f"{', '.join(DEFAULT_ARCHS)}")
    ap.add_argument("--window", type=int, default=8,
                    help="micro-batch admission window size")
    ap.add_argument("--publish-every", type=int, default=1,
                    help="learner tick cadence, in routed windows")
    ap.add_argument("--snapshot", default=None,
                    help="save the final router snapshot here (.npz)")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus telemetry scrape")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower the FULL decode configs (not ported yet: "
                    "raises NotImplementedError)")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the router and the models")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run needs launch/dryrun, which is not ported yet")

    import numpy as np

    from repro_torch.core.costs import price_from_active_params
    from repro_torch.core.features import fit_pca_whitener, hash_encode_batch
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import make_request_stream
    from repro_torch.serving import PortfolioServer, ServedModel

    arch_ids = args.arch or list(DEFAULT_ARCHS)
    tiers = ["budget", "mid", "frontier"]
    corpus = [r["prompt"] for r in make_request_stream(400, seed=7)]
    whitener = fit_pca_whitener(hash_encode_batch(corpus), device=args.device)
    models = []
    for i, a in enumerate(arch_ids):
        smoke = configs.get_smoke(a)
        # price the arm from the FULL architecture's active params
        pricing = price_from_active_params(
            a, configs.get_config(a).active_params(), mean_req_tokens=600)
        models.append(ServedModel.init(smoke, pricing, tiers[min(i, 2)],
                                       seed=i, device=args.device))
        print(f"arm {i}: {a} @ ${pricing.price_per_1k:.2e}/1k tok "
              f"({tiers[min(i, 2)]})")

    server = PortfolioServer(models, whitener, budget=args.budget,
                             router_cfg=RouterConfig(max_arms=8),
                             max_new_tokens=4, device=args.device)
    stream = list(make_request_stream(args.requests, seed=11))
    results, backlog, windows = [], [], 0

    def flush():
        server.feedback_batch(
            [r.request_id for r in backlog],
            np.asarray([r.arm for r in backlog]),
            np.asarray([r.reward for r in backlog]),
            np.asarray([r.cost for r in backlog]))
        backlog.clear()

    for i in range(0, len(stream), args.window):
        served = server.serve_batch(stream[i:i + args.window],
                                    defer_feedback=True)
        results.extend(served)
        backlog.extend(served)
        windows += 1
        if windows % args.publish_every == 0:
            flush()
    if backlog:
        flush()
    reward = np.mean([r.reward for r in results])
    cost = np.mean([r.cost for r in results])
    traffic = {m.name: 0 for m in models}
    for r in results:
        traffic[r.model] += 1
    print(f"\nserved {len(results)} requests: reward {reward:.3f}, "
          f"cost ${cost:.2e}/req ({cost / args.budget:.2f}x ceiling)")
    print("traffic:", traffic)
    m = server.metrics()
    print(f"lambda_t = {m['lam']:.3f}  snapshot v{m['snapshot_version']:.0f}"
          f"  route p50/p95 = {m['route_p50_us']:.1f}/"
          f"{m['route_p95_us']:.1f} µs/dec"
          f"  pulls = {[round(m[f'pull_rate_{k}'], 3) for k in range(3)]}")
    if args.snapshot:
        snap = server.gateway.save(args.snapshot)
        print(f"snapshot v{snap.version} (t={snap.step}) -> {args.snapshot}")
    if args.prom:
        print(server.prometheus_text())


if __name__ == "__main__":
    main()
