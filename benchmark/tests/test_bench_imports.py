"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``nightmare_rl_tpu`` (compared whole: ``nightmare_rl_tpu_torch``
is the program), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_whole_name_comparison():
    names = ["nightmare_rl_tpu_torch", "nightmare_rl_tpu_torch.rl.ppo",
             "jaxtyping", "flaxen", "benchmark.reference"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(["jax.numpy", "nightmare_rl_tpu.rl"]) == [
        "jax.numpy", "nightmare_rl_tpu.rl"]


def test_harness_and_program_load_no_jax():
    top = _loaded("import benchmark.harness, benchmark.program, "
                  "benchmark.trace, benchmark.readings, benchmark.run\n"
                  "from benchmark import program\n"
                  "import nightmare_rl_tpu_torch.rl.ppo, "
                  "nightmare_rl_tpu_torch.envs.nightmare_v3, "
                  "nightmare_rl_tpu_torch.envs.anymal_c")
    assert not top & set(guard.FORBIDDEN)
    assert "nightmare_rl_tpu_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import benchmark.reference.ppo, benchmark.check, "
                  "benchmark.counts.ppo\n"
                  "import benchmark.reference.plain.envs.nightmare_v3, "
                  "benchmark.reference.plain.envs.anymal_c")
    assert not top & {*guard.FORBIDDEN, "nightmare_rl_tpu_torch"}


def _strings_and_imports(src: str):
    """The string constants (docstrings left out) and imported modules of
    a source."""
    tree = ast.parse(src)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)
            and isinstance(n.value, ast.Constant)}
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
               and isinstance(n.value, str) and id(n) not in docs]
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    return strings, mods


def test_no_source_imports_jax_or_reads_the_old_benchmark():
    """Nothing under benchmark/ imports JAX or the JAX package, or names
    bench.py, BENCH_*, MULTICHIP_*, BASELINE.* or nightmare_rl_tpu/ in a
    string it could open."""
    bench = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(bench):
        for f in files:
            if not f.endswith(".py") or f == os.path.basename(__file__):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                strings, mods = _strings_and_imports(fh.read())
            assert not guard.forbidden_modules(mods), f
            for s in strings:
                for word in ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE.",
                             "nightmare_rl_tpu/"):
                    assert word not in s, (f, s)
