"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; names compared whole."""
from __future__ import annotations

from bench_cells import one_thread  # noqa: F401  (sys.path, one thread)

import subprocess
import sys

from bench_cells import BENCH, ROOT


def _modules(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = ['{ROOT}', '{BENCH}', '{BENCH / 'reference'}']\n"
            + code + "\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_tiny_run_loads_no_jax():
    mods = _modules(
        "import time, torch; torch.set_num_threads(1)\n"
        "sys.path.insert(0, '" + str(BENCH / 'tests') + "')\n"
        "import run, bench_cells, harness\n"
        "assert run.execute(bench_cells.serve_cell(), 7, 0.2, False, 'cpu', time.time()) == 0\n"
        "assert harness.forbidden_modules() == []")
    assert not mods & {"jax", "jaxlib", "flax", "videoglamm_tpu"}
    assert "videoglamm_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import vgref.serve, vgref.train, checks, weights, workload_gen, flops")
    assert not mods & {"videoglamm_torch", "jax", "jaxlib", "flax", "videoglamm_tpu"}


def test_forbidden_names_are_compared_whole():
    import harness
    sys.modules["videoglamm_tpu_lookalike_for_test"] = sys.modules["harness"]
    try:
        assert "videoglamm_tpu_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["videoglamm_tpu_lookalike_for_test"]
