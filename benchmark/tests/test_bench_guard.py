"""The import guard compares whole top-level names."""
from benchmark.harness import guard


def test_jax_and_the_jax_package_are_caught():
    found = guard.forbidden_modules({"jax", "jax.numpy", "flax.linen",
                                     "libsplinter_tpu", "libsplinter_tpu.ops",
                                     "numpy"})
    assert found == ["flax", "jax", "libsplinter_tpu"]


def test_the_port_is_not_the_jax_package():
    assert guard.forbidden_modules({"libsplinter_tpu_torch",
                                    "libsplinter_tpu_torch.engine",
                                    "jaxtyping", "torch"}) == []


def test_the_harness_and_the_port_load_no_jax(tmp_path):
    import subprocess
    import sys

    from benchmark.harness.spec import ROOT

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness.ingest\n"
            "import benchmark.harness.gen, benchmark.control\n"
            "import libsplinter_tpu_torch.engine.embedder\n"
            "from benchmark.harness.guard import forbidden_modules\n"
            "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
