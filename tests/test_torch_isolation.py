"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro``, and the port's entry
points refuse to run without a device when no CUDA card is present."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")

_IMPORT = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                     re.M)


def test_port_imports_without_jax_or_repro():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    assert len(MODULES) >= 15


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    assert not _IMPORT.search(path.read_text()), path


def test_entry_points_need_a_device(monkeypatch):
    from repro_torch.configs import llama_7b_paper
    from repro_torch.core import inference as PI
    from repro_torch.models.transformer import init_lm
    from repro_torch.params import params_from_numpy

    from repro_torch.core.masks import segment_layout
    from repro_torch.data.synthetic import sample_kv_batch
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim.adamw import AdamWConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_7b_paper.smoke(compute_dtype="float32")
    layout = segment_layout(2, 4, 2, 4)
    for call in (lambda: init_lm(cfg, 0),
                 lambda: TrainLoop(cfg, layout, AdamWConfig(), 1),
                 lambda: sample_kv_batch(torch.Generator(), layout, 1),
                 lambda: params_from_numpy({}, cfg),
                 lambda: PI.init_online_state(cfg, 1, 8),
                 lambda: PI.init_cache(cfg, 1, 8),
                 lambda: PI.init_cache(cfg, 1, 8, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    st = PI.init_online_state(cfg, 1, 8, device="cpu")
    assert st.cache.k.device.type == "cpu" and st.mem.k.device.type == "cpu"


_TIMER = re.compile(
    r"\btime\.(time|perf_counter|perf_counter_ns|monotonic|monotonic_ns|"
    r"process_time|thread_time)\s*\(|^\s*from\s+time\s+import\b|"
    r"^\s*import\s+time\b", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_only_the_obs_clock_reads_a_stdlib_timer(path):
    """All port timing goes through ``repro_torch.obs.clock``, which
    reads the stdlib clock through the ``_time`` alias that
    ``scripts/check_no_stray_timers.py`` lets pass."""
    code = "\n".join(line.split("#", 1)[0]
                     for line in path.read_text().splitlines())
    if path == PORT / "obs" / "clock.py":
        assert "import time as _time" in code
        assert "_time.perf_counter()" in code
    else:
        assert not _TIMER.search(code), path


def test_serve_engine_needs_a_device_and_refuses_unported_options(
        monkeypatch):
    from repro_torch.configs import llama_7b_paper
    from repro_torch.serve import ServeEngine

    cfg = llama_7b_paper.smoke(compute_dtype="float32")
    for kw, slice_name in ((dict(stream_slots=2), "streaming"),
                           (dict(n_shards=2), "multi-device"),
                           (dict(mesh=object()), "multi-device")):
        with pytest.raises(NotImplementedError, match=slice_name):
            ServeEngine(None, cfg, device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(None, cfg, n_slots=2, cache_len=8)
    eng = ServeEngine(None, cfg, n_slots=2, cache_len=8, device="cpu")
    assert eng._mgr["online"].arena.slabs.cache.k.device.type == "cpu"
