"""Closed-loop serving of fixed batches of chips, as ``val`` and ``predict
--mode chips`` serve them: each batch is filled into the pinned slot of
the program's ``eval/runner.py::BatchPipeline`` and run through
``S2ANetPredictor.predict`` (forward, decode, multiclass rotated NMS); the
next batch is filled as soon as the pipeline takes it, and a batch's
detections reach the host one batch later.

Traffic parameters (``traffic/<mix>.json``): ``batch``, ``pool`` (seeded
chips, made on the device and kept in pinned host memory), ``score_thr``,
``sample_batches`` (batches of the window whose
detections the reference checks, drawn from the seed) and
``profile_batches`` (the traced run's profiled stretch, after the window).

End-to-end: ``chips_per_s`` (chips whose detections reached the host over
the window's seconds) and ``setup_s``.
"""

from __future__ import annotations

import gc
import os
import queue
import tempfile
import threading
import time

import numpy as np
import torch

from .. import compare, images, roofline, trace, weights
from ..flops import reference_flops


class _Timed:
    """The predictor as the pipeline's step, with the host time of each
    ``predict`` call (the enqueue: the call returns before the device ends)."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.device = predictor.device
        self.enqueue = []

    def predict(self, x):
        t0 = time.perf_counter()
        with torch.profiler.record_function("s2a_bench.predict"):
            out = self.predictor.predict(x)
        self.enqueue.append(time.perf_counter() - t0)
        return out


def make_predictor(cfg: dict, traffic: dict, state_dict: dict, device, quant: bool = False,
                   dtype=None):
    """The program's predictor on the seeded weights (written to a file of
    ``TMPDIR``, which the predictor loads as a ``state_dict``)."""
    from s2anet_tpu_torch.config import ModelConfig
    from s2anet_tpu_torch.predict import S2ANetPredictor
    fields = ModelConfig.__dataclass_fields__
    mc = ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                        for k, v in cfg["model"].items() if k in fields})
    mc.score_thr = traffic["score_thr"]
    if quant:
        mc.quant = "int8"
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    try:
        torch.save({k: v.cpu() for k, v in state_dict.items()}, path)
        dt = dtype or getattr(torch, cfg["eval"]["dtype"])
        return S2ANetPredictor(mc, weights=path, device=str(device), dtype=dt)
    finally:
        os.unlink(path)


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The seeded chips ``[pool, S, S, 3]`` uint8 on the device."""
    size = cfg["data"]["img_size"]
    gen = torch.Generator(device=device).manual_seed((seed * 7919 + 1) % (1 << 63))
    return images.square_chips(traffic["pool"], size, gen, device)


def batch_indices(n_pool: int, batch: int, seed: int):
    """The pool indices of batch ``i``: a seeded order of the pool, cut in
    consecutive batches that cycle."""
    order = np.random.default_rng(seed).permutation(n_pool)

    def of(i: int) -> np.ndarray:
        return order[(i * batch + np.arange(batch)) % n_pool]
    return of


def run(run, fault=None) -> None:
    cell, device, seed = run.cell, run.device, run.seed
    cfg, traffic = cell.config, cell.traffic
    from s2anet_tpu_torch.eval.runner import BatchPipeline

    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
        # float32 as the configuration states it: TF32 on or off
        tf32 = bool(cfg["eval"].get("tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    run.mark("imports")
    sd = weights.make_state_dict(cfg["model"], cfg["init"], seed, device)
    run.mark("weights")
    predictor = make_predictor(cfg, traffic, sd, device)
    del sd
    run.mark("predictor")
    b, size = traffic["batch"], cfg["data"]["img_size"]
    pool_dev = make_pool(cfg, traffic, seed, device)
    pool = pool_dev.cpu().pin_memory() if device.type == "cuda" else pool_dev.cpu()
    del pool_dev
    run.mark("inputs")
    pool_np = pool.numpy()
    of = batch_indices(len(pool), b, seed)
    step = _Timed(predictor)
    if fault is not None:
        step = fault(step)
    rng = np.random.default_rng(seed + 1)
    k_sample = traffic["sample_batches"]
    sample = {}  # reservoir of batch index -> outputs
    waits = {"loader_wait": 0.0, "device_wait": 0.0}
    count = [0]  # batches fed so far, over every phase

    with BatchPipeline(step, b, size, device=device) as pipe:
        def phase(until):
            """``pipe.run`` over batches fed while ``until()``: a loader
            thread fills the pipeline's free slots ahead, as the evaluation
            loader's threads do; each run numbers its slots from 0, the
            batches go on counting."""
            ready = queue.Queue(maxsize=max(pipe.n - 2, 1))
            stop = threading.Event()

            def load():
                i = 0
                while not stop.is_set():
                    slot = pipe.slot(i)
                    g = count[0]
                    count[0] += 1
                    for j, k in enumerate(of(g)):
                        slot[j] = pool_np[k]
                    i += 1
                    while not stop.is_set():
                        try:
                            ready.put((b, g), timeout=0.05)
                            break
                        except queue.Full:
                            pass

            loader = threading.Thread(target=load, daemon=True)
            loader.start()

            def feed():
                try:
                    while until():
                        with torch.profiler.record_function("s2a_bench.wait_loader"):
                            item = ready.get()
                        yield item
                finally:
                    stop.set()
                    loader.join()
            return pipe.run(feed(), waits)

        warm = traffic.get("warmup_batches", 3)
        run.mark("pipeline")
        fed_warm = [0]

        def until_warm():
            fed_warm[0] += 1
            return fed_warm[0] <= warm

        for _ in phase(until_warm):
            pass
        if device.type == "cuda":
            torch.cuda.synchronize()
        step.enqueue.clear()
        run.mark_setup_done()
        first = count[0]
        t0 = time.perf_counter()
        done = 0
        for outs, nb, g in phase(lambda: time.perf_counter() - t0 < run.seconds):
            done += 1
            # a reservoir sample of the window's batches, drawn from the seed
            r = done - 1 if done <= k_sample else int(rng.integers(0, done))
            if r < k_sample:
                sample[r] = (g, tuple(np.array(a) for a in outs))
        window = time.perf_counter() - t0
        run.mark("window")
        run.attempted = done
        run.metrics["chips_per_s"] = done * b / window
        run.metrics["setup_s"] = run.setup_s
        enqueue = list(step.enqueue)
        if run.trace:
            n_prof = traffic["profile_batches"]
            fed, n_fed = [], [0]

            def until_prof():
                n_fed[0] += 1
                return n_fed[0] <= n_prof

            gen = phase(until_prof)

            def prof_step(k):
                g = next(gen, None)
                if g is not None:
                    fed.append(g[2])
            run.timeline = trace.profile(prof_step, n_prof)
            for _ in gen:
                pass
            run.layer["prof_batches"] = [of(g) for g in fed]
    if device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    run.layer.update(rate=run.metrics["chips_per_s"], enqueue_ms=1e3 * float(np.mean(enqueue)),
                     batch=b, window_batches=done, first_window_batch=first)
    del predictor, step, pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the sampled batches' detections against the reference
    sd = weights.make_state_dict(cfg["model"], cfg["init"], seed, device)
    torch.backends.cudnn.benchmark = False  # the reference runs each shape once
    picked = [sample[k] for k in sorted(sample)]
    imgs = torch.cat([pool[torch.from_numpy(of(i))] for i, _ in picked])
    served = [np.concatenate([o[k] for _, o in picked]) for k in range(3)]
    t_check = time.perf_counter()
    run.readings = compare.serve_readings(cfg, sd, imgs, served, traffic["score_thr"], device)
    run.readings["check_s"] = time.perf_counter() - t_check
    run.mark("check")
    if run.trace:
        _layer_inputs(run, cfg, traffic, sd, pool, device)
        run.mark("layer_inputs")


def _layer_inputs(run, cfg, traffic, sd, pool, device) -> None:
    """What the per-layer readers need beside the timeline: FLOPs a chip of
    the reference and the chip's peak in the serving type, the AlignConv's
    and the NMS's bounds a batch."""
    size, b = cfg["data"]["img_size"], traffic["batch"]
    mc, dtype = cfg["model"], cfg["eval"]["dtype"]
    run.layer["flops_per_item"] = reference_flops(mc, 1, size, size, train=False)
    run.layer["peak_flop_s"] = roofline.PEAK_FLOP_S[dtype]
    lv = roofline.level_sizes(size, size, mc["strides"])
    run.layer["align_fwd_bound_s"] = roofline.bound_s(
        *roofline.align_fwd(b, lv, elem=roofline.ELEM_BYTES[dtype]), roofline.PEAK_FLOP_S[dtype])
    # the NMS's work on the profiled batches' own candidates (the reference's)
    distinct = {tuple(ix.tolist()) for ix in run.layer["prof_batches"]}
    per_set = {}
    for ix in distinct:
        cand, labels, valid = compare.reference_candidates(
            cfg, sd, pool[torch.tensor(ix)], traffic["score_thr"], device)
        nb, ops = roofline.nms_work(cand, labels, valid)
        per_set[ix] = roofline.bound_s(nb, ops, roofline.F32_FLOP_S)
    run.layer["nms_bound_s"] = float(np.mean([per_set[tuple(ix.tolist())]
                                              for ix in run.layer["prof_batches"]]))
