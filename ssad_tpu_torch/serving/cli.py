"""Serving subcommands: export, serve, serve-bench, score,
evaluate-artifact.

Counterpart of ssad_tpu/serving/cli.py (cmd_export :39-130, cmd_serve
:208-255, cmd_serve_bench :257-333, cmd_score :334-580,
cmd_evaluate_artifact :583-657, the flags at :660-831) with ``--device``
added: the commands run on the CUDA device unless ``--device cpu`` is
given, and fail with a clear message when there is no card.  Image and
patch artifacts with the k-NN (``--coreset`` too) or Mahalanobis scorer,
float32, bfloat16 or int8 weights (``--dtype``), ``--validate``,
``/admin/reload`` through ``serve``, the load generator against an
in-process server or a ``--url``, ``score --url`` through
``ServingClient`` are ported; ``--devices`` replicas and the native front
end are not (the JAX flags ``--devices`` and ``--frontend`` are absent).
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
    the fitted scorer and calibrated threshold (serving/export.py)."""
    import sys

    from ssad_tpu_torch.serving.export import export_checkpoint
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.coreset is not None and args.scorer == "mahalanobis":
        print("note: --coreset has no effect with --scorer mahalanobis (the Gaussian's "
              "mean/precision are fixed size regardless of row count; a maximin subset "
              "would bias the moments) — flag ignored", file=sys.stderr)
    elif args.coreset is not None and (args.knn_k is None or args.knn_k > 1):
        print("note: --coreset with k>1 scoring: a maximin-spread bank makes the 2nd/3rd "
              "neighbors far by construction, inflating normal scores — consider --knn-k 1",
              file=sys.stderr)
    ckpt = Path(args.models_dir) / args.subject / "best_model.ckpt"
    out = args.out or str(
        Path(args.models_dir) / args.subject / f"{args.subject}_{args.mode}.ssadpt"
    )
    def export(out_path, dtype):
        return export_checkpoint(
            ckpt, out_path, mode=args.mode, batch=args.batch,
            imsize=(args.imsize, args.imsize) if args.imsize else None,
            k=args.knn_k, seed=args.seed, subject=args.subject, device=device,
            allow_pickle=args.allow_pickle, dataset_dir=args.dataset_dir,
            n_normality_images=args.n_normality_images, patch_dim=args.patch_dim,
            stride=args.stride, scorer=args.scorer, coreset=args.coreset, dtype=dtype,
        )

    path = export(out, args.dtype)
    validation = _validate(path, args, device, export) if args.validate else None
    print(json.dumps({
        "artifact": path,
        "validation": validation,
        "mode": args.mode,
        "bytes": Path(path).stat().st_size,
    }))
    return 0


def _validate(path, args, device, export) -> dict:
    """``export --validate``: the artifact on seeded uniform images is
    finite; with ``--dtype`` a float32 twin of the same configuration
    (same seed: the same fit and threshold) is exported beside it, scored
    on the same images and deleted, and the largest score drift (and in
    image mode the label agreement) is reported."""
    import numpy as np

    from ssad_tpu_torch.serving.export import load_scorer

    scorer = load_scorer(path, device)
    h, w = scorer.meta["imsize"]
    x = np.random.default_rng(args.seed).uniform(size=(args.batch, h, w, 3)).astype(np.float32)
    res = scorer(x)
    validation = {"finite": bool(all(np.isfinite(r).all() for r in res))}
    if args.dtype:
        ref_path = export(str(Path(path).with_suffix(".float_ref.ssadpt")), None)
        try:
            ref = load_scorer(ref_path, device)(x)
            validation["max_abs_score_drift"] = float(
                np.max(np.abs(res[0].astype(np.float64) - ref[0])))
            if args.mode == "image":
                validation["label_agreement"] = float(np.mean(res[1] == ref[1]))
        finally:
            Path(ref_path).unlink(missing_ok=True)
    return validation


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

    def load():
        return _load_artifact_models(args.artifact, args.max_delay_ms, args.max_queue, device)

    models, warmup_s = load()
    # POST /admin/reload re-runs the loader: the same paths, re-read (a
    # newer export in their place), warmed, swapped in under traffic
    server = AnomalyHTTPServer(
        host=args.host, port=args.port, score_timeout=args.score_timeout, models=models,
        reloader=load,
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


def cmd_serve_bench(args) -> int:
    """Load-benchmark the serving stack (serving/loadgen.py): concurrent
    POSTs against an in-process server over --artifact (warmed before
    traffic) or a running one at --url.  Prints one JSON line: qps, client
    latency percentiles, shed and error counts, the server's /stats."""
    from urllib.parse import urlparse

    from ssad_tpu_torch.serving import loadgen
    from ssad_tpu_torch.serving.server import AnomalyHTTPServer
    from ssad_tpu_torch.utils.device import resolve_device

    if bool(args.url) == bool(args.artifact):
        raise SystemExit("pass exactly one of --url or --artifact")
    server = None
    if args.artifact:
        device = resolve_device(args.device)
        models, _ = _load_artifact_models(args.artifact, args.max_delay_ms, args.max_queue,
                                          device)
        server = AnomalyHTTPServer(host="127.0.0.1", port=0, score_timeout=args.score_timeout,
                                   models=models)
        server.start()
        host, port = "127.0.0.1", server.port
        if args.model and args.model not in models:
            server.stop()
            raise SystemExit(f"--model {args.model!r} not among {sorted(models)}")
        if len(models) == 1:
            (_, meta), path = next(iter(models.values())), "/score"
        else:
            name = args.model or sorted(models)[0]
            meta, path = models[name][1], f"/score/{name}"
        imsize = tuple(meta["imsize"])
    else:
        u = urlparse(args.url)
        if u.scheme not in ("", "http"):
            raise SystemExit(f"--url scheme {u.scheme!r} is not supported (the load "
                             "generator speaks plain http)")
        if not u.hostname:
            raise SystemExit(f"cannot parse host from --url {args.url!r}")
        host, port = u.hostname, u.port or 80
        path = f"/score/{args.model}" if args.model else (
            u.path if u.path and u.path != "/" else "/score")
        imsize = (args.imsize, args.imsize)
    body = loadgen.npy_body(imsize, seed=args.seed)
    try:
        if args.warmup:
            # uncounted: warms connections and the server's threads
            loadgen.run_load(host, port, body, path=path,
                             concurrency=min(args.concurrency, 4), total=args.warmup)
        report = loadgen.run_load(host, port, body, path=path, concurrency=args.concurrency,
                                  total=args.requests, timeout=args.score_timeout + 30.0,
                                  rate=args.rate)
        report["target"] = f"http://{host}:{port}{path}"
        report["server_stats"] = loadgen.fetch_stats(host, port)
    finally:
        if server is not None:
            server.stop()
    print(json.dumps(report))
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

    if bool(args.url) == bool(args.artifact):
        raise SystemExit("pass exactly one of --artifact or --url")
    if args.url:
        return _score_remote(args)
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


def _score_remote(args) -> int:
    """``score --url``: post each file's bytes to a running server
    (serving/client.py; it decodes and resizes), write scores.csv (and
    heatmaps) as the local command does, and keep going past per-file
    client errors (4xx → errors.csv); a 5xx or a lost connection stops
    the run with the partial results kept."""
    import csv

    from PIL import Image

    from ssad_tpu_torch.serving.client import ServingClient, ServingError

    client = ServingClient(args.url, model=args.model, timeout=300.0, retries=4)
    health = client.healthz()
    if "models" in health:
        if not args.model:
            raise SystemExit(f"server hosts several models ({sorted(health['models'])}); "
                             "pass --model")
        if args.model not in health["models"]:
            raise SystemExit(f"server does not host model {args.model!r}; available: "
                             f"{sorted(health['models'])}")
        mode = health["models"][args.model]
    else:
        mode = health.get("mode", "image")
    if args.heatmaps and mode != "patch":
        raise SystemExit("--heatmaps needs a patch-mode model")
    paths = _collect_images(args.images)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    heat_dir = None
    if args.heatmaps:
        heat_dir = out_dir / "heatmaps"
        heat_dir.mkdir(exist_ok=True)
    csv_path, err_path = out_dir / "scores.csv", out_dir / "errors.csv"
    n_rows = n_anomalous = 0
    errors = []
    threshold = None

    def flush_errors():
        if errors:
            with open(err_path, "w", newline="") as ef:
                ew = csv.writer(ef)
                ew.writerow(["path", "status", "error"])
                ew.writerows(errors)

    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["path", "map_max", "map_mean"] if mode == "patch"
                    else ["path", "score", "label"])
        for i, p in enumerate(paths):
            try:
                out = client.score_file(p, heatmap=bool(heat_dir))
            except ServingError as e:
                if e.status >= 500:
                    flush_errors()
                    raise SystemExit(f"{p}: server failure — {e}")
                errors.append((str(p), e.status, str(e)))
                continue
            except OSError as e:
                flush_errors()
                raise SystemExit(f"{p}: connection to {args.url} failed after {n_rows} scored "
                                 f"files — {e!r}; partial results in {csv_path}")
            if mode == "patch":
                wr.writerow([str(p), out["map_max"], out["map_mean"]])
                if heat_dir is not None:
                    Image.fromarray(out["heatmap"]).save(heat_dir / f"{i:05d}_{p.stem}.png")
            else:
                threshold = out.get("threshold", threshold)
                n_anomalous += int(out["label"])
                wr.writerow([str(p), out["score"], out["label"]])
            n_rows += 1
            f.flush()
    flush_errors()
    summary = {"mode": mode, "n": n_rows, "csv": str(csv_path), "url": args.url,
               "n_errors": len(errors)}
    if errors:
        summary["errors_csv"] = str(err_path)
    if mode == "image":
        summary["n_anomalous"] = n_anomalous
        summary["threshold"] = threshold
    if heat_dir is not None:
        summary["heatmaps"] = str(heat_dir)
    print(json.dumps(summary))
    return 0


def cmd_evaluate_artifact(args) -> int:
    """Accuracy of an exported artifact on labelled MVTec test data — the
    check a bfloat16 or int8 artifact needs before it serves: the artifact
    itself, its baked threshold included, is what is measured.  Prints one
    JSON line: image AUROC / F1 (image mode) or pixel AUROC / IoU / AUPRO
    (patch mode), from the host metric oracles."""
    import numpy as np

    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import metrics as M
    from ssad_tpu_torch.serving.export import load_scorer
    from ssad_tpu_torch.utils.device import resolve_device

    scorer = load_scorer(args.artifact, resolve_device(args.device))
    meta = scorer.meta
    subject = args.subject or meta.get("subject")
    if not subject:
        raise SystemExit(f"{args.artifact} has no subject in its header; pass --subject")
    h, w = meta["imsize"]
    test = mvtec.prepare_mvtec_test_data(args.dataset_dir, subject, imsize=(h, w))
    labels = test.labels > 0
    out = {"artifact": str(args.artifact), "subject": subject, "mode": meta.get("mode"),
           "dtype": meta.get("weights_dtype"), "scorer": meta.get("scorer", "knn"),
           "n_test": int(labels.shape[0])}
    chunks = [scorer(test.images[lo : lo + args.chunk])
              for lo in range(0, test.images.shape[0], args.chunk)]
    results = tuple(np.concatenate(parts) for parts in zip(*chunks))
    if meta.get("mode") == "image":
        scores, served_labels = results[0], results[1]
        fpr, tpr, _ = M.roc_curve(labels, scores)
        thr = M.optimal_f1_threshold(labels, scores)
        out.update({
            "image_auroc": round(float(M.auc(fpr, tpr)), 4),
            "f1_optimal": round(float(M.f1_score(labels, scores, thr)), 4),
            # what production sees: verdicts at the threshold baked at export
            "baked_threshold": meta.get("threshold"),
            "f1_at_baked_threshold": round(float(M.f1_score(
                labels, scores, float(meta["threshold"]))), 4),
            "served_anomaly_rate": round(float(np.mean(served_labels)), 4),
        })
    else:
        maps = results[0]
        gts = np.asarray(test.ground_truths)
        flat_gt, flat_scores = gts.ravel() > 0, np.nan_to_num(maps.ravel())
        if flat_gt.any() and not flat_gt.all():
            fpr, tpr, _ = M.roc_curve(flat_gt, flat_scores)
            thr = M.optimal_f1_threshold(flat_gt, flat_scores)
            fprs, pros = M.compute_pro(maps, gts)
            out.update({
                "pixel_auroc": round(float(M.auc(fpr, tpr)), 4),
                "iou": round(float(M.iou_score(gts.ravel(), flat_scores, thr)), 4),
                "aupro": round(float(M.compute_aupro(fprs, pros, args.aupro_fpr_limit)), 4),
            })
        else:
            out["error"] = "test set has no (or only) defective pixels"
    print(json.dumps(out))
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
                    help="default: the checkpoint's TrainConfig imsize, else "
                         "DataConfig().imsize (256)")
    ex.add_argument("--knn-k", type=int, default=None,
                    help="default: EvalConfig().knn_k")
    ex.add_argument("--scorer", default="knn", choices=["knn", "mahalanobis"],
                    help="anomaly scorer in the artifact: the k-NN bank (reference "
                         "parity) or a Gaussian scored by Mahalanobis distance")
    ex.add_argument("--coreset", type=int, default=None,
                    help="distil the k-NN bank to N rows by k-center-greedy coreset "
                         "selection after the calibration split (default: every row)")
    ex.add_argument("--seed", type=int, default=0,
                    help="seed of the 70/30 calibration split and the coreset's first row")
    ex.add_argument("--dtype", default=None, choices=["bfloat16", "int8"],
                    help="serving weights: a bfloat16 cast (half the bytes) or weight-only "
                         "per-channel int8 (about a quarter, serving/quant.py); the bank "
                         "and the k-NN stay float32")
    ex.add_argument("--validate", action="store_true",
                    help="score seeded random images with the artifact (finite); with "
                         "--dtype also export a float32 twin of the same configuration "
                         "and report the largest score drift and the label agreement")
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

    sb = sub.add_parser("serve-bench",
                        help="load-benchmark the serving stack (qps, client latency "
                             "percentiles, shed rate)")
    sb.add_argument("--artifact", nargs="+", default=None,
                    help="start an in-process server over these artifacts and benchmark it")
    sb.add_argument("--url", default=None,
                    help="benchmark a running server instead (e.g. http://127.0.0.1:8000)")
    sb.add_argument("--model", default=None,
                    help="model name on a multi-model server (POST /score/<name>)")
    sb.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop workers, each keeping one request in flight")
    sb.add_argument("--requests", type=int, default=200)
    sb.add_argument("--rate", type=float, default=None,
                    help="open loop: offer this many requests/s on a fixed schedule and "
                         "measure latency from each scheduled arrival (default: closed loop)")
    sb.add_argument("--warmup", type=int, default=16,
                    help="uncounted warmup requests before timing; 0 skips")
    sb.add_argument("--imsize", type=int, default=256,
                    help="--url only: the request image's side (--artifact reads it from "
                         "the artifact)")
    sb.add_argument("--max-delay-ms", type=float, default=5.0)
    sb.add_argument("--max-queue", type=int, default=256,
                    help="admission bound of the in-process server; 0 disables")
    sb.add_argument("--score-timeout", type=float, default=60.0)
    sb.add_argument("--seed", type=int, default=0)
    add_device_flag(sb)
    sb.set_defaults(fn=cmd_serve_bench)

    ea = sub.add_parser("evaluate-artifact",
                        help="accuracy of an exported artifact on labelled MVTec test data")
    ea.add_argument("--artifact", required=True)
    ea.add_argument("--dataset-dir", required=True)
    ea.add_argument("--subject", default=None, help="default: the artifact header's subject")
    ea.add_argument("--chunk", type=int, default=32, help="test images scored per call")
    ea.add_argument("--aupro-fpr-limit", type=float, default=0.3)
    add_device_flag(ea)
    ea.set_defaults(fn=cmd_evaluate_artifact)

    sc = sub.add_parser("score", help="offline scoring of image files/folders")
    sc.add_argument("--artifact", default=None, help="one artifact (image or patch mode)")
    sc.add_argument("--url", default=None,
                    help="score against a running server instead (raw file bytes are "
                         "posted, the server decodes and resizes; per-file 4xx errors go "
                         "to errors.csv and the run continues)")
    sc.add_argument("--model", default=None,
                    help="with --url: the model's name on a multi-model server")
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
