"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level names; the reference imports nothing of the port."""

import subprocess
import sys

from lpbench import harness, registry


def test_top_level_names_compared_whole():
    found = harness.forbidden_modules(
        ["jax.numpy", "jaxlib", "firstorderlp_torch", "firstorderlp_torch.ops",
         "jaxtyping", "flaxen", "firstorderlp_tpu_extra", "os"])
    assert found == ["jax", "jaxlib"]
    assert harness.forbidden_modules(["firstorderlp_tpu.models"]) == [
        "firstorderlp_tpu"]
    assert harness.forbidden_modules(["firstorderlp_torch"]) == []


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=registry.REPO, capture_output=True, text=True, check=True,
        timeout=300)
    return set(out.stdout.split())


def test_the_run_imports_no_jax():
    tops = _loaded(
        "from lpbench import harness, registry, tracing, roofline\n"
        "registry.entry('lp_solve')\n"
        "for m in registry.benchmark()['per_layer']:\n"
        "    registry.metric(m['name'])\n"
        "for c in registry.benchmark()['configs']:\n"
        "    registry.generator(registry.config(c['name'])['generator'])\n")
    assert "firstorderlp_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_imports_neither_the_port_nor_jax():
    tops = _loaded("import lpbench.reference.judge, lpbench.reference.kkt,"
                   " lpbench.reference.control, lpbench.reference.pagerank,"
                   " lpbench.pagerank")
    assert not tops & {"firstorderlp_torch", *harness.FORBIDDEN}
