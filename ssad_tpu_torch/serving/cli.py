"""Serving subcommands: export, serve, score.

Counterpart of ssad_tpu/serving/cli.py (cmd_export :39, cmd_serve :208,
cmd_score :334, the flags at :658-741) with ``--device`` added: the
commands run on the CUDA device unless ``--device cpu`` is given, and
fail with a clear message when there is no card.  Image and patch (k-NN)
artifacts are ported; the JAX CLI's quantized and Mahalanobis exports,
``--coreset``, ``serve-bench``, ``evaluate-artifact``, remote
``score --url``, replicas and the native front end wait for later slices.
"""

from __future__ import annotations

import json
from pathlib import Path


def add_device_flag(p) -> None:
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the command runs (default: cuda; without a "
                        "card only --device cpu works)")


def cmd_export(args) -> int:
    """<models-dir>/<subject>/best_model.ckpt → a serving artifact with
    the fitted bank and calibrated threshold (serving/export.py)."""
    from ssad_tpu_torch.serving.export import export_checkpoint
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ckpt = Path(args.models_dir) / args.subject / "best_model.ckpt"
    out = args.out or str(
        Path(args.models_dir) / args.subject / f"{args.subject}_{args.mode}.ssadpt"
    )
    path = export_checkpoint(
        ckpt, out, mode=args.mode, batch=args.batch,
        imsize=(args.imsize, args.imsize) if args.imsize else None,
        k=args.knn_k, seed=args.seed, subject=args.subject, device=device,
        allow_pickle=args.allow_pickle, dataset_dir=args.dataset_dir,
        n_normality_images=args.n_normality_images, patch_dim=args.patch_dim,
        stride=args.stride,
    )
    print(json.dumps({
        "artifact": path,
        "mode": args.mode,
        "bytes": Path(path).stat().st_size,
    }))
    return 0


def _load_artifact_models(paths, max_delay_ms: float, max_queue, device):
    """Artifact paths → ({name: (BatchingScorer, meta)}, warmup_s).

    Each scorer is warmed THROUGH its batcher before it takes traffic:
    the batcher's collector thread is the one that runs the scorer, and
    PyTorch creates cuDNN/cuBLAS handles per thread, so a warmup on the
    loading thread would leave that first cost to the first request."""
    import numpy as np

    from ssad_tpu_torch.serving.export import load_scorer, warm_call
    from ssad_tpu_torch.serving.server import BatchingScorer

    models = {}
    total_warmup = 0.0
    for path in paths:
        scorer = load_scorer(path, device)
        name = scorer.meta.get("subject") or Path(path).stem
        if name in models:
            raise SystemExit(f"duplicate model name {name!r} ({path})")
        batcher = BatchingScorer(scorer, batch=scorer.batch, max_delay_ms=max_delay_ms,
                                 max_queue=max_queue or None)
        h, w = scorer.meta["imsize"]
        total_warmup += warm_call(batcher.score, np.zeros((h, w, 3), np.float32))
        models[name] = (batcher, scorer.meta)
    return models, total_warmup


def cmd_serve(args) -> int:
    """Serve artifacts over HTTP with dynamic batching until interrupted
    (Ctrl-C or SIGTERM drain in-flight requests and close the socket)."""
    import signal
    import time

    from ssad_tpu_torch.serving.server import AnomalyHTTPServer
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    models, warmup_s = _load_artifact_models(
        args.artifact, args.max_delay_ms, args.max_queue, device
    )
    server = AnomalyHTTPServer(
        host=args.host, port=args.port, score_timeout=args.score_timeout, models=models
    )
    server.start()
    print(json.dumps({
        "host": args.host,
        "port": server.port,
        "models": {n: m.get("mode") for n, (_, m) in models.items()},
        "device": str(device),
        "warmup_s": round(warmup_s, 2),
    }), flush=True)

    def _sigterm(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _collect_images(items) -> list:
    """Files and/or directories → sorted list of image paths."""
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".npy"}
    paths = []
    for item in items:
        p = Path(item)
        if p.is_dir():
            paths.extend(q for q in sorted(p.rglob("*")) if q.suffix.lower() in exts)
        elif p.exists():
            paths.append(p)
        else:
            raise SystemExit(f"no such file or directory: {item}")
    if not paths:
        raise SystemExit("no images found under the given paths")
    return paths


def cmd_score(args) -> int:
    """Offline scoring of image files/folders with an artifact: writes
    scores.csv as each chunk completes (path,score,label; for a patch
    artifact path,map_max,map_mean and, with --heatmaps, one grayscale
    PNG per image) and prints one JSON summary."""
    import csv

    import numpy as np
    from PIL import Image

    from ssad_tpu_torch.data.mvtec import load_image
    from ssad_tpu_torch.serving.export import load_scorer
    from ssad_tpu_torch.serving.server import coerce_image_array, heatmap_to_uint8
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    scorer = load_scorer(args.artifact, device)
    h, w = scorer.meta["imsize"]
    mode = scorer.meta.get("mode", "image")
    if args.heatmaps and mode != "patch":
        raise SystemExit("--heatmaps needs a patch-mode artifact")
    paths = _collect_images(args.images)

    def load_any(p: Path) -> np.ndarray:
        if p.suffix.lower() == ".npy":
            # the [0,1]/uint8 contract the HTTP front end enforces
            return coerce_image_array(np.load(p), (h, w))
        return load_image(p, (h, w))

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    heat_dir = None
    if args.heatmaps:
        heat_dir = out_dir / "heatmaps"
        heat_dir.mkdir(exist_ok=True)
    csv_path = out_dir / "scores.csv"
    n_rows = n_anomalous = 0
    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["path", "map_max", "map_mean"] if mode == "patch"
                    else ["path", "score", "label"])
        for lo in range(0, len(paths), args.chunk):
            batch_paths = paths[lo : lo + args.chunk]
            results = scorer(np.stack([load_any(p) for p in batch_paths]))
            if mode == "patch":
                for i, (p, m) in enumerate(zip(batch_paths, results[0])):
                    wr.writerow([str(p), float(m.max()), float(m.mean())])
                    if heat_dir is not None:
                        # the index prefix keeps equal stems of different folders apart
                        Image.fromarray(heatmap_to_uint8(m)).save(
                            heat_dir / f"{lo + i:05d}_{p.stem}.png"
                        )
            else:
                scores, labels = results[0], results[1]
                n_anomalous += int(labels.sum())
                for p, s, y in zip(batch_paths, scores, labels):
                    wr.writerow([str(p), float(s), int(y)])
            n_rows += len(batch_paths)
            f.flush()
    summary = {
        "mode": mode,
        "n": n_rows,
        "csv": str(csv_path),
        "threshold": scorer.meta.get("threshold"),
        "device": str(device),
    }
    if mode == "image":
        summary["n_anomalous"] = n_anomalous
    if heat_dir is not None:
        summary["heatmaps"] = str(heat_dir)
    print(json.dumps(summary))
    return 0


def register(sub) -> None:
    """Add the serving subcommand parsers to the main CLI's subparsers."""
    ex = sub.add_parser("export", help="export a checkpoint as a serving artifact")
    ex.add_argument("--models-dir", required=True)
    ex.add_argument("--subject", required=True)
    ex.add_argument("--out", default=None,
                    help="artifact path (default: "
                         "<models-dir>/<subject>/<subject>_<mode>.ssadpt)")
    ex.add_argument("--mode", default="image", choices=["image", "patch"],
                    help="image-level scores, or patch-level anomaly maps")
    ex.add_argument("--dataset-dir", default=None,
                    help="MVTec root, required for --mode patch: patch normality "
                         "is re-embedded from <dataset-dir>/<subject>/train/good "
                         "(the checkpoint's bank holds whole-image embeddings)")
    ex.add_argument("--n-normality-images", type=int, default=None,
                    help="cap the training images embedded for patch normality "
                         "(a seeded sample; default: all)")
    ex.add_argument("--patch-dim", type=int, default=32)
    ex.add_argument("--stride", type=int, default=8)
    ex.add_argument("--batch", type=int, default=8,
                    help="fixed serving batch the scorer pads to")
    ex.add_argument("--imsize", type=int, default=None,
                    help="default: DataConfig().imsize (256)")
    ex.add_argument("--knn-k", type=int, default=None,
                    help="default: EvalConfig().knn_k")
    ex.add_argument("--seed", type=int, default=0,
                    help="seed of the 70/30 calibration split")
    ex.add_argument("--allow-pickle", action="store_true",
                    help="permit full unpickling of a checkpoint you trust")
    add_device_flag(ex)
    ex.set_defaults(fn=cmd_export)

    sv = sub.add_parser("serve", help="serve artifacts over HTTP (dynamic batching)")
    sv.add_argument("--artifact", required=True, nargs="+",
                    help="one or more artifacts; several load behind one "
                         "port, routed by POST /score/<subject>")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="max time a request waits for its batch to fill")
    sv.add_argument("--max-queue", type=int, default=256,
                    help="requests beyond this many pending get HTTP 503; 0 disables")
    sv.add_argument("--score-timeout", type=float, default=60.0,
                    help="per-request scoring timeout in seconds")
    add_device_flag(sv)
    sv.set_defaults(fn=cmd_serve)

    sc = sub.add_parser("score", help="offline scoring of image files/folders")
    sc.add_argument("--artifact", required=True)
    sc.add_argument("images", nargs="+",
                    help="image files and/or directories (searched "
                         "recursively for png/jpg/bmp/tif/npy)")
    sc.add_argument("--out", default="outputs/score",
                    help="output directory for scores.csv")
    sc.add_argument("--chunk", type=int, default=64,
                    help="images decoded/held on host per scoring call")
    sc.add_argument("--heatmaps", action="store_true",
                    help="patch artifacts: also write one grayscale PNG per map "
                         "under <out>/heatmaps")
    add_device_flag(sc)
    sc.set_defaults(fn=cmd_score)
