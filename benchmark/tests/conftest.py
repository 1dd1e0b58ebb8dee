"""The benchmark's own tests: on the CPU here, at narrow widths; the tests
marked `card` run on an NVIDIA card and skip elsewhere (each decides in its
body).

    python -m pytest benchmark/tests -q
"""

import os

TINY = {
    "settings": {"down_filters": [8, 8, 8, 8, 8, 8], "up_filters": [8, 8, 8, 8, 8, 8]},
    "traffic": {"batch_size": 8, "train_pairs": 16, "steps_per_chunk": 2,
                "compute_dtype": "float32", "trace_chunks": 1},
}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def checkout_copy(dst, cells=(), metrics=()):
    """BENCHMARK.json and benchmark/ copied to `dst` (a pathlib.Path), with
    `cells` and `metrics` added to BENCHMARK.json; returns `dst`."""
    import json
    import shutil

    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "benchmark"), dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"] += list(cells)
    bench["per_layer"] += list(metrics)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")
