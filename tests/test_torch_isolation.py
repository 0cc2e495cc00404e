"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's CLIs (``examples/*_torch.py``, ``scripts/serve_metrics_torch.py``)
import neither ``jax``, the reference package ``repro`` nor the
reference's ``benchmarks``, and the port's entry points refuse to run
without a device when no CUDA card is present."""
import dataclasses
import functools
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

_IMPORT = re.compile(r"^\s*(import\s+(jax|repro|benchmarks)\b|"
                     r"from\s+(jax|repro|benchmarks)(\.|\s))", re.M)


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


EXAMPLES = ("train_online_torch", "quickstart_torch", "serve_online_torch",
            "streaming_demo_torch", "serve_many_users_torch")
CLIS = [ROOT / "examples" / f"{name}.py" for name in EXAMPLES] \
    + [ROOT / "scripts" / "serve_metrics_torch.py"]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"] + CLIS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    assert not _IMPORT.search(path.read_text()), path


@pytest.mark.parametrize("cli", CLIS, ids=lambda p: p.name)
def test_clis_run_without_jax_and_need_a_device(cli):
    """Each CLI runs with ``jax`` and ``repro`` unimportable (``--help``)
    and, with no card and no ``--device``, raises the port's no-device
    error rather than falling back to the CPU."""
    stub = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    help_ = subprocess.run([sys.executable, "-c", stub, str(cli), "--help"],
                           capture_output=True, text=True, env=env,
                           timeout=120, cwd=ROOT)
    assert help_.returncode == 0, help_.stderr
    assert "--device" in help_.stdout
    run = subprocess.run([sys.executable, "-c", stub, str(cli), "--steps",
                          "1"] if "train" in cli.name else
                         [sys.executable, "-c", stub, str(cli)],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=ROOT)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr


def _load(path: Path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CPU_RUNS = {
    "quickstart_torch": ([], "query accuracy FROM MEMORY ONLY"),
    "serve_online_torch": ([], "accuracy from memory"),
    "streaming_demo_torch": (["--tokens", "64"], "StreamingLLM (drop)"),
    "serve_many_users_torch": (["--metrics"],
                               "accuracy from compressed memory"),
    "train_online_torch": (["--ablate-lora"], "default     LoRA acc@t4"),
}


@pytest.fixture
def one_thread():
    """One intra-op thread: the CLIs' small ops stall on contended thread
    pools when several test workers share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(_CPU_RUNS))
def test_examples_run_on_the_cpu(name, capsys, one_thread):
    """Each example CLI runs end to end on the CPU at 2 training steps
    (``--device cpu``; the card is their default) and prints its last
    result line."""
    extra, line = _CPU_RUNS[name]
    mod = _load(ROOT / "examples" / f"{name}.py")
    assert mod.main(["--device", "cpu", "--steps", "2"] + extra) == 0
    assert line in capsys.readouterr().out


def test_dryrun_needs_no_jax_no_xla_flags_and_no_card():
    """``launch.dryrun`` imports with ``jax`` and ``repro`` unimportable,
    sets no ``XLA_FLAGS`` and calls nothing of ``torch.cuda`` at import
    (every such call raises here), and its source touches no
    environment variable."""
    code = ("import os, sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('a CUDA call at import')\n"
            "for f in ('is_available', 'device_count', 'current_device',\n"
            "          'init', '_lazy_init', 'synchronize', 'get_device_name'):\n"
            "    setattr(torch.cuda, f, refuse)\n"
            "import repro_torch.launch.dryrun as D\n"
            "assert 'XLA_FLAGS' not in os.environ\n"
            "print('ok', len(D.VARIANTS))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    assert "environ" not in (PORT / "launch" / "dryrun.py").read_text()


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


_ENGINE_CASES = {
    # sharded serving: a 2-shard loop and a 2-device session mesh of CPU
    # "devices" construct on the CPU
    "n_shards": (dict(n_shards=2, n_slots=4, cache_len=8, device="cpu"),
                 None, None),
    "mesh": (dict(mesh="cpu:2", n_slots=4, cache_len=8, device="cpu"),
             None, None),
    # no card: the engine raises unless given device="cpu"
    "no-device": (dict(n_slots=2, cache_len=8), RuntimeError,
                  "no CUDA device"),
    "no-device-stream": (dict(n_slots=2, cache_len=8, stream_slots=2),
                         RuntimeError, "no CUDA device"),
    # no card: a session mesh on the card raises too
    "no-device-mesh": (dict(mesh="cuda", n_slots=2, cache_len=8),
                       RuntimeError, "no CUDA device"),
    # stream sessions are ported: a stream arena on the CPU
    "stream-arena": (dict(n_slots=2, cache_len=8, stream_slots=2,
                          device="cpu"), None, None),
}


@pytest.mark.parametrize("case", list(_ENGINE_CASES))
def test_serve_engine_needs_a_device_and_refuses_unported_options(
        monkeypatch, case):
    from repro_torch.configs import llama_7b_paper
    from repro_torch.launch.mesh import make_session_mesh
    from repro_torch.serve import ServeEngine

    cfg = llama_7b_paper.smoke(compute_dtype="float32")
    kw, exc, match = _ENGINE_CASES[case]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(kw)

    def build():
        if "mesh" in kw:            # "type:n": n shards on that device type
            dev, _, n = kw["mesh"].partition(":")
            kw["mesh"] = make_session_mesh(int(n or 1), device=dev)
        return ServeEngine(None, cfg, **kw)

    if exc is not None:
        with pytest.raises(exc, match=match):
            build()
        return
    eng = build()
    online = eng._mgr["online"].arena
    if "stream_slots" in kw:
        stream = eng._mgr["stream"].arena
        assert stream.slabs.win_k.device.type == "cpu"
        assert tuple(stream.slabs.win_k.shape) == (
            3, cfg.n_layers, 1, cfg.ccm.stream_window, cfg.n_kv_heads,
            cfg.hd)
        assert online.slabs.cache.k.device.type == "cpu"
        return
    assert eng.n_shards == online.n_shards == 2
    assert [eng.create_session(f"s{i}") for i in range(4)] == [0, 1, 0, 1]
    if "mesh" in kw:          # one row block (2 slots + scratch) a device
        blocks = online.slabs.blocks
        assert [b.cache.k.shape[0] for b in blocks] == [3, 3]
        assert online.devices == kw["mesh"].devices
    else:
        assert online.slabs.cache.k.shape[0] == 6


def _unported_cases():
    """Multi-device options whose refusal slice 14 settles: a family
    other than dense and MoE on a mesh that splits the model now builds
    its train step and its stream step, a prefill or an ingest over a
    sequence-sharded cache builds too, and the reference's ZeRO-3 train
    cell builds, on a shape-only mesh (ROADMAP item 4b-v: every rank's
    ``param_spec`` blocks; the model axis's and the data axes' process
    groups are taken at the first call).  (Sharded MoE,
    item 4b-ii, is ``tests/test_torch_moe_tp.py``; the other families,
    ``tests/test_torch_tp_families.py``; the sequence-sharded prefill and
    ingest, item 4b-sp, ``tests/test_torch_seq_shard.py``.)"""
    from repro_torch.configs import whisper_tiny
    from repro_torch.core.masks import segment_layout
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch import mesh as PM
    from repro_torch.launch import serve as SRV
    from repro_torch.launch.specs import build_cell
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim.adamw import AdamWConfig

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

    dist = DistContext(mesh=Mesh())
    cfg = whisper_tiny.smoke(compute_dtype="float32")
    dense = ModelConfig(name="d", family="dense", n_layers=1, d_model=64,
                        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128)
    return {
        "train-n_model": lambda: make_train_step(
            cfg, segment_layout(2, 4, 2, 4), AdamWConfig(), dist=dist),
        # the reference's ZeRO-3 train cell (ROADMAP 4b-v)
        "train-fsdp-cell": lambda: build_cell(
            dense.replace(sharding_strategy="fsdp", ccm=dataclasses.replace(
                dense.ccm, max_steps=2)), "train_4k",
            PM.make_dist(PM.make_shape_mesh((2, 2), ("data", "model"))),
            smoke=True),
        "prefill-seq-shard": lambda: SRV.make_prefill_step(
            dense, dist, shard_cache_seq=True, batch_sharded=False),
        "ingest-seq-shard": lambda: SRV.make_ingest_step(
            dense, dist, shard_cache_seq=True, batch_sharded=False),
        "stream-step-dist": lambda: SRV.make_stream_step(cfg, dist=dist),
    }


@pytest.mark.parametrize("case", ["train-n_model", "prefill-seq-shard",
                                  "ingest-seq-shard", "stream-step-dist",
                                  "train-fsdp-cell"])
def test_unported_multi_device_options_name_slice_14(case):
    if case == "train-fsdp-cell":
        # each rank stores its blocks: d_ff 128's wi (1, 64, 128) on its
        # last dim, the 128 vocabulary rows of embed and lm_head's columns
        cell = _unported_cases()[case]()
        tp, fp = cell.args[0], cell.args[1]
        assert tuple(fp["layers"]["mlp"]["wi"].shape) == (1, 64, 64)
        assert tuple(fp["embed"].shape) == (64, 64)
        assert tuple(cell.local_args[3]["tokens"].shape)[0] == 1
        assert callable(cell.fn)
        return
    assert callable(_unported_cases()[case]())


def _fsdp_ep_cases(tmp_path):
    """Every ``dist=`` entry point, given ``moe_impl="ep"`` under
    ``sharding_strategy="fsdp"`` on a model axis of 2 (ROADMAP item
    4b-v-c, done), built on a shape-only (2, 2) mesh as rank (0, 0):
    each returns what it returns under ``tp``, and what a rank stores is
    its ``param_spec`` blocks.  (The numbers are
    ``tests/test_torch_fsdp.py``'s.)"""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import phi35_moe
    from repro_torch.core.masks import segment_layout
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed.elastic import remesh_restore
    from repro_torch.launch import mesh as PM
    from repro_torch.launch import serve as SRV
    from repro_torch.launch import train as TR
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import partition as PP
    from repro_torch.optim.adamw import AdamWConfig

    mesh = PM.make_shape_mesh((2, 2), ("data", "model"))
    dist = PM.make_dist(mesh)
    cfg = phi35_moe.smoke(compute_dtype="float32").replace(
        moe_impl="ep", sharding_strategy="fsdp")
    layout = segment_layout(2, 4, 2, 4)
    step = TR.make_train_step(cfg.replace(sharding_strategy="tp"), layout,
                              AdamWConfig(), dist)
    whole = init_lm(cfg, 0, device="cpu")
    blocks = FS.shard_fsdp(whole, cfg, dist)

    def same_blocks(tree, ref=blocks):
        """``tree`` holds exactly ``ref``'s shapes at its leaves' paths."""
        ref = dict(PP.leaves(ref))
        return all(tuple(x.shape) == tuple(ref[p].shape)
                   for p, x in PP.leaves(tree)) and bool(PP.leaves(tree))

    def loop():
        loop = TR.TrainLoop(cfg, layout, AdamWConfig(), 4, dist=dist,
                            device="cpu")
        return same_blocks(loop.tp)

    def remesh():
        ckpt = CheckpointManager(str(tmp_path), async_save=False)
        tp, _ = PP.partition(whole, TR.trainable_mask_for(cfg, whole))
        ckpt.save(1, {"tp": tp}, extra={"step": 1})
        state, extra, _ = remesh_restore(ckpt, 1, cfg, mesh, {"tp": tp},
                                         None)
        return extra["step"] == 1 and same_blocks(state["tp"])

    cases = {
        "make_train_step": lambda: callable(TR.make_train_step(
            cfg, layout, AdamWConfig(), dist)),
        "jit_train_step": lambda: same_blocks(TR.jit_train_step(
            step, cfg, dist, None, None, {}, None).place(whole, {})[0]),
        "TrainLoop": loop,
        "remesh_restore": remesh,
        "make_prefill_step": lambda: same_blocks(SRV.make_prefill_step(
            cfg, dist).place(whole, None)[0]),
        "make_decode_step": lambda: same_blocks(SRV.make_decode_step(
            cfg, dist).place(whole, None)[0]),
        "make_ingest_step": lambda: same_blocks(SRV.make_ingest_step(
            cfg, dist).place(whole, None)[0]),
        "make_stream_step": lambda: same_blocks(SRV.make_stream_step(
            cfg, dist).place(whole, None)[0]),
    }
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        cases[f"build_cell-{shape}"] = functools.partial(
            lambda sh: callable(build_cell(cfg, sh, dist, smoke=True).fn),
            shape)
    return cases


@pytest.mark.parametrize("case", ["make_train_step", "jit_train_step",
                                  "TrainLoop", "remesh_restore",
                                  "make_prefill_step", "make_decode_step",
                                  "make_ingest_step", "make_stream_step",
                                  "build_cell-train_4k",
                                  "build_cell-prefill_32k",
                                  "build_cell-decode_32k",
                                  "build_cell-long_500k"])
def test_fsdp_ep_entry_points_build(case, tmp_path, monkeypatch):
    """ep under ZeRO-3 runs: every entry point builds, a rank storing its
    ZeRO-3 blocks.  (The shape mesh has no process group: the loop asks
    torch.distributed for its rank, which is 0.)"""
    from repro_torch.launch import train as TR
    monkeypatch.setattr(TR.tdist, "get_rank", lambda *a, **k: 0)
    assert _fsdp_ep_cases(tmp_path)[case]() is True


def test_no_port_module_names_roadmap_item_4b_v_c():
    """No port module names ROADMAP item 4b-v-c in a refusal any more."""
    hits = [str(p) for p in PORT.rglob("*.py") if "4b-v-c" in p.read_text()]
    assert not hits, hits


def test_no_port_module_refuses_the_sequence_sharded_prefill():
    """No port module names ROADMAP item 4b-sp in a refusal any more."""
    hits = [str(p) for p in PORT.rglob("*.py") if "4b-sp" in p.read_text()]
    assert not hits, hits
