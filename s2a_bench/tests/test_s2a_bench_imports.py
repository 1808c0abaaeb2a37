"""Nothing of the benchmark imports JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

from __future__ import annotations

import subprocess
import sys
import sys as _sys

from s2a_bench import harness


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
                         cwd=harness.ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(harness.ROOT)})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    tops = _modules_after("import s2a_bench.run, s2a_bench.drivers.serve_closed, "
                          "s2a_bench.drivers.train_steps, s2a_bench.control\n"
                          "import s2anet_tpu_torch.predict, s2anet_tpu_torch.train.step")
    assert "s2anet_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    tops = _modules_after("import s2a_bench.reference.model, s2a_bench.reference.post, "
                          "s2a_bench.reference.train, s2a_bench.reference.geometry")
    assert "s2anet_tpu_torch" not in tops and not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(_sys.modules, "s2anet_tpu_torch_probe", _sys)
    assert "s2anet_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(_sys.modules, "s2anet_tpu.models", _sys)
    assert harness.forbidden_modules() == ["s2anet_tpu"]
