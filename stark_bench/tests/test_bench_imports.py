"""Nothing the benchmark imports on the chip is JAX or the JAX package, by
top-level module names compared whole (``tpu_stark_torch`` begins with
``tpu_stark``), and the reference imports nothing of the port."""

import os
import subprocess
import sys

from stark_bench import run

ROOT = run.ROOT


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in out.stdout.split()}


def _all_modules() -> list:
    mods = []
    for base, _dirs, files in os.walk(os.path.join(ROOT, "stark_bench")):
        if "__pycache__" in base or os.sep + "tests" in base[len(ROOT):]:
            continue
        for f in files:
            if f.endswith(".py") and f != "__init__.py" and os.sep + "metrics" not in base[len(ROOT):]:
                rel = os.path.relpath(os.path.join(base, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, "."))
    return mods


def test_no_jax_anywhere_in_the_benchmark():
    code = "\n".join(f"import {m}" for m in _all_modules())
    code += "\nfrom stark_bench import run\nfor m in run.benchmark()['per_layer'] + run.benchmark()['end_to_end']:\n"
    code += "    run.load_metric(m['name'])\nimport tpu_stark_torch.prover.wide, tpu_stark_torch.prover.prove"
    found = _modules(code)
    assert not found & set(run.BANNED), found & set(run.BANNED)
    assert "tpu_stark_torch" in found


def test_reference_imports_nothing_of_the_port():
    found = _modules("import stark_bench.reference, stark_bench.inputs.fib, stark_bench.reference.uni_stark, "
                     "stark_bench.reference.fib_air")
    assert "tpu_stark_torch" not in found and not found & set(run.BANNED)
