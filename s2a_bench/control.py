"""The readings that the check's limits are set from, for one cell:

    python3 s2a_bench/control.py --workload <name> --sound 12 --control 3 [--seconds 3]

in one process, on the card, at the cell's own sizes:

* ``--sound`` seeds of the program as the benchmark runs it (a short
  window at the cell's load: the check compares what it produced), whose
  largest readings are the lower ends of the limits;
* ``--faults`` (each on ``--fault-seeds`` seeds): the faults of
  ``faults.py`` planted under the timed path;
* ``--control`` seeds of the control, which computes one precision below
  the configuration's and has to fail the check: for serving, which the
  configurations state as float32 with TF32 off, the program with TF32
  switched on; for training, bfloat16, where the program has no lower
  precision, the reference itself with every conv's input, weight, output
  and gradient rounded to symmetric int8 (``reference/model.py``), in the
  program's place;
* ``--bf16`` seeds of the program's serving path at bfloat16, and
  ``--ref-bf16`` seeds of the plain reference under bfloat16 autocast in
  the program's place: what a precision alone moves, with no code of the
  program in the second.

Prints one JSON line per seed, with whether the cell's limits pass it
(``harness.check_limits``), and a summary. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from s2a_bench import compare, faults, harness, weights  # noqa: E402
from s2a_bench.drivers import serve_closed, train_steps  # noqa: E402
from s2a_bench.reference import post  # noqa: E402


def autocast_bf16(net):
    """``net`` whose forward runs under bfloat16 autocast, its outputs
    returned as float32."""
    inner, device_type = net.forward, next(net.parameters()).device.type

    def forward(*args, **kwargs):
        with torch.autocast(device_type=device_type, dtype=torch.bfloat16):
            out = inner(*args, **kwargs)
        return {k: [t.float() for t in v] for k, v in out.items()}
    net.forward = forward
    return net


class RefPredictor:
    """The plain reference as the serving step: forward under bfloat16
    autocast, then the reference's decode + NMS."""

    def __init__(self, cfg, state_dict, score_thr, device):
        self.net = autocast_bf16(compare.reference_model(cfg, state_dict, device, train=False))
        self.mc, self.score_thr, self.device = cfg["model"], score_thr, device

    @torch.no_grad()
    def predict(self, imgs):
        out = self.net(compare.as_input(torch.as_tensor(imgs).to(self.device)))
        boxes, scores, labels, keep = post.detections(post.level_scores(out), self.mc,
                                                      self.score_thr)
        return torch.cat([boxes, scores[..., None]], -1), labels, keep


def swap_predictor(cell, seed, device, kind):
    """A serving step factory that puts ``kind`` in the program's place:
    ``bf16`` the program at bfloat16, ``ref_bf16`` the reference."""
    def wrap(step):
        cfg, traffic = cell.config, cell.traffic
        sd = weights.make_state_dict(cfg["model"], cfg["init"], seed, device)
        if kind == "bf16":
            step.predictor = serve_closed.make_predictor(cfg, traffic, sd, device,
                                                         dtype=torch.bfloat16)
        else:
            step.predictor = RefPredictor(cfg, sd, traffic["score_thr"], device)
        return step
    return wrap


def tf32_control(step):
    """The serving step with TF32 switched on under the program's float32
    path (convolutions and matrix products at TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return step


def train_control(cell, seed, device, precision: str = "int8") -> dict:
    """The reference at int8 (or under bfloat16 autocast: ``"bf16"``) in
    the program's place, judged against the float32 reference."""
    cfg, traffic = cell.config, cell.traffic
    gts = train_steps.gt_batches(cfg, traffic, seed)
    imgs = train_steps.make_images(cfg, traffic, seed, device).cpu()
    batches = [dict(gts[k], imgs=imgs[k]) for k in range(train_steps.CHECKED_STEPS)]
    sd = weights.make_state_dict(cfg["model"], cfg["init"], seed, device)
    if precision == "bf16":
        net = autocast_bf16(compare.reference_model(cfg, sd, device, train=True))
    else:
        net = compare.reference_model(cfg, sd, device, train=True, precision=precision)
    dev_batches = [{"imgs": compare.as_input(b["imgs"].to(device)),
                    "gt_boxes": torch.as_tensor(b["gt_boxes"]).to(device),
                    "gt_classes": torch.as_tensor(b["gt_classes"]).to(device),
                    "gt_mask": torch.as_tensor(b["gt_mask"]).to(device)} for b in batches]
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    items, first, _, _ = compare.ref_train.sgd_steps(net, dev_batches, cfg["model"], cfg["train"])
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    prog = {"items": items.cpu().numpy(),
            "first": {n: float(v) for n, v in zip(names, first)},
            "change": {n: float((p.detach() - start[n]).norm())
                       for n, p in net.named_parameters()}}
    del net, start
    gc.collect()
    torch.cuda.empty_cache()
    return compare.train_readings(cfg, sd, batches, prog, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--ref-bf16", type=int, default=0)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", default="", help="comma-separated names of faults.py")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seed0", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda:0", help="cpu: a trial at a tiny size")
    opt = p.parse_args(argv)
    cell = harness.load_cell(opt.workload)
    device = torch.device(opt.device)
    serving = cell.traffic["driver"] == "serve_closed"
    driver = serve_closed if serving else train_steps
    table = faults.SERVE if serving else faults.TRAIN
    plan = ([("sound", None)] * opt.sound + [("control", None)] * opt.control
            + [("ref_bf16", None)] * opt.ref_bf16 + [("bf16", None)] * opt.bf16)
    for name in filter(None, opt.faults.split(",")):
        plan += [("fault", name)] * opt.fault_seeds
    results = {}
    for k, (kind, name) in enumerate(plan):
        seed = opt.seed0 + 7 * k
        t0 = time.perf_counter()
        if kind in ("control", "ref_bf16") and not serving:
            readings = train_control(cell, seed, device,
                                     "int8" if kind == "control" else "bf16")
        else:
            wrap = (tf32_control if kind == "control"
                    else swap_predictor(cell, seed, device, kind) if kind in ("bf16", "ref_bf16")
                    else table[name] if kind == "fault" else None)
            run = harness.Run(cell, seed, opt.seconds, False, device, time.perf_counter())
            driver.run(run, fault=wrap)
            readings = run.readings
        label = kind if name is None else f"fault:{name}"
        results.setdefault(label, []).append(readings)
        passes = harness.check_limits(types.SimpleNamespace(cell=cell, readings=readings))
        print(json.dumps({"seed": seed, "kind": label, "correct": passes, "readings": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    keys = sorted({k for rs in results.values() for r in rs for k, v in r.items()
                   if isinstance(v, float)})
    summary = {label: {k: [r.get(k) for r in rs] for k in keys} for label, rs in results.items()}
    print(json.dumps({"workload": opt.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
