"""The configurations' counts of FLOPs and bytes against hand counts of
one request each."""
from benchmark.harness import spec


def _cfg(name):
    cell_cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
    mod = spec.load_module(spec.BENCH_DIR / "configs" / f"{name}.py", name)
    return cell_cfg, mod


def test_nomic_counts():
    cfg, mod = _cfg("nomic-embed-text-v1.5")
    # a layer: q/k/v 3 x 768^2, out 768^2, SwiGLU gate/up/down 3 x 768 x 3072
    per_layer = 3 * 768 * 768 + 768 * 768 + 3 * 768 * 3072
    assert mod.layer_matmul_params(cfg) == per_layer == 9_437_184
    n = 300
    want = 2 * 12 * per_layer * n + 12 * 4 * n * n * 768
    assert mod.flops(cfg, [n]) == float(want)
    assert mod.weight_bytes(cfg) == 2 * 12 * per_layer


def test_e5_counts():
    cfg, mod = _cfg("e5-large-v2")
    per_layer = 4 * 1024 * 1024 + 2 * 1024 * 4096
    assert mod.layer_matmul_params(cfg) == per_layer == 12_582_912
    n = 200
    want = 2 * 24 * per_layer * n + 24 * 4 * n * n * 1024
    assert mod.flops(cfg, [n]) == float(want)
    assert mod.flops(cfg, [n, n]) == 2.0 * want
    assert mod.weight_bytes(cfg) == 2 * 24 * per_layer


def test_specs_keep_the_published_widths():
    cfg, mod = _cfg("nomic-embed-text-v1.5")
    s = mod.spec(cfg)
    assert (s["hidden"], s["heads"], s["mlp"], s["layers"], s["vocab"]) == \
        (768, 12, 3072, 12, 30528)
    cfg, mod = _cfg("e5-large-v2")
    s = mod.spec(cfg)
    assert (s["hidden"], s["heads"], s["mlp"], s["layers"], s["vocab"]) == \
        (1024, 16, 4096, 24, 30522)
