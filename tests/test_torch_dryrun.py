"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta``
device: its counts against closed forms written here, the ZeRO-3
cells' storage and gathers, and its record's keys against the reference's
(``repro/launch/dryrun.py``'s record, read from its source: the
reference's dry run needs 512 placeholder devices, so it is not run)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import llama_7b_paper
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PS

ROOT = Path(__file__).resolve().parents[1]


def _tiny(**kw):
    """LLaMA-7B's smoke config in float32, grouped-query (4 / 2 heads)."""
    return llama_7b_paper.smoke(compute_dtype="float32",
                                param_dtype="float32").replace(n_kv_heads=2,
                                                               **kw)


def _decode_flops(cfg, B: int, clen: int) -> float:
    """A decode step's FLOPs by hand: per layer the four projections
    (x W alone: a decoded token is no <COMP> token, so the conditional
    LoRA does not fire), 4 hd FLOPs for each visible (q, k) pair of each
    query head (the full memory, the clen - 1 cached keys and the token
    itself), the SwiGLU MLP's three products; then the head."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def proj(K, N):
        return 2 * B * K * N
    projections = proj(d, Hq * hd) + 2 * proj(d, Hkv * hd) + proj(Hq * hd, d)
    pairs = cfg.ccm.mem_len + (clen - 1) + 1
    attention = 4 * hd * B * Hq * pairs
    mlp = 3 * 2 * B * d * f
    return L * (projections + attention + mlp) + 2 * B * d * V


def test_decode_flops_equal_the_closed_form():
    cfg = _tiny()
    B, S = 3, 40
    cell = PS.build_decode_cell(cfg, PS.ShapeSpec("decode", S, B), None)
    rec = D.measure(cell)
    assert rec["cost"]["flops"] == _decode_flops(cfg, B, S)
    # the kernels' share: one segmented attention launch a layer
    calls, flops, nbytes = rec["kernels"]["segmented_attention"]
    assert calls == cfg.n_layers and nbytes > 0
    assert flops == cfg.n_layers * 4 * cfg.hd * B * cfg.n_heads * (
        cfg.ccm.mem_len + S)
    assert rec["collective_bytes"] == {}
    # what the rank holds: the params, the state and the tokens, exactly
    want = sum(x.numel() * x.element_size()
               for x in D._tensors(cell.args))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_bytes"] >= want


def test_collective_bytes_on_a_2x2_mesh_equal_the_closed_form():
    """On a shape-only (data 2, model 2) mesh, a decode step's all-reduces
    a device receives: the vocab-parallel embedding's, then each layer's
    two partial sums (after the attention's ``wo``, after the MLP's),
    each (B / 2, 1, d) float32; the logits stay the rank's vocabulary
    block, so nothing is gathered."""
    cfg = _tiny()
    B = 4
    mesh = PM.make_shape_mesh((2, 2), ("data", "model"))
    dist = PM.make_dist(mesh)
    cell = PS.build_decode_cell(cfg, PS.ShapeSpec("decode", 24, B), dist)
    rec = D.measure(cell, mesh.counts)
    row = (B // 2) * cfg.d_model * 4
    assert rec["collective_bytes"] == {
        "all-reduce": (2 * cfg.n_layers + 1) * row}
    assert rec["collective_total"] == (2 * cfg.n_layers + 1) * row
    # rank 0's rows of the tokens, its half of the heads' cache
    assert tuple(cell.args[2].shape) == (B, 1)
    assert tuple(cell.local_args[2].shape) == (B // 2, 1)
    k = cell.local_args[1].cache.k
    assert tuple(k.shape) == (cfg.n_layers, B // 2, 24, cfg.n_kv_heads // 2,
                              cfg.hd)


def test_train_cell_counts_its_backward():
    """A train step counts its backward: the CCM attention's backward
    launch a layer at 10 hd FLOPs a pair against the forward's 4, and
    under remat the forward twice (the recompute)."""
    cfg = _tiny()
    cell = PS.build_train_cell(cfg, PS.ShapeSpec("train", 256, 2), None)
    rec = D.measure(cell)
    fwd, bwd = rec["kernels"]["ccm_attention"], \
        rec["kernels"]["ccm_attention_backward"]
    assert bwd[0] == cfg.n_layers and fwd[0] == 2 * cfg.n_layers
    assert bwd[1] / bwd[0] == 2.5 * fwd[1] / fwd[0]
    assert rec["cost"]["flops"] > fwd[1] + bwd[1] + \
        rec["kernels"]["cond_lora"][1]


def _spec_bytes(tree, specs, dist) -> int:
    """The bytes of a rank's blocks of ``tree``'s leaves by ``specs``."""
    from repro_torch.distributed import tensor_parallel as TPX
    from repro_torch.optim import partition as PP
    total = 0
    for path, x in PP.leaves(tree):
        spec = specs
        for k in path:
            spec = spec[k]
        y = TPX.shard_by_spec(x, spec, dist)
        total += y.numel() * y.element_size()
    return total


def _gathered(tree, cfg, n: int):
    """(top-level, stacked) whole bytes of the leaves stored cut."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.optim import partition as PP
    top = layers = 0
    for path, x in PP.leaves(tree):
        if FS.gather_dim(path, cfg, n) is None:
            continue
        if path[0] == "layers":
            layers += x.numel() * x.element_size()
        else:
            top += x.numel() * x.element_size()
    return top, layers


def test_fsdp_train_cell_names_roadmap_item_4b_v(tmp_path):
    """The ZeRO-3 cells (ROADMAP item 4b-v, done) on the 16 x 16 shape
    mesh: what a rank holds of the weights and moments is exactly its
    blocks by the reference's specs (``param_pspecs``, no departure); the
    train step gathers the top-level leaves once and every layer's twice
    (the remat recompute), and reduce-scatters each trainable stored
    block once; a decode step gathers every stored leaf once and
    reduce-scatters nothing.  The batch lies over all 256 ranks."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as TR
    from repro_torch.optim import partition as PP
    mesh = PM.make_shape_mesh(*PM.PRODUCTION["single"])
    dist = PM.make_dist(mesh)
    cfg = _tiny(sharding_strategy="fsdp")
    assert cfg.remat and cfg.train_mode == "lora"
    pshapes = PS.params_specs(cfg)
    specs = SH.param_pspecs(cfg, pshapes, dist)
    cell = PS.build_train_cell(cfg, PS.ShapeSpec("train", 512, 256), dist)
    rec = D.measure(cell, mesh.counts)
    tp_s, fp_s, opt_s, rows, _ = cell.local_args
    assert D._storage_bytes(D._tensors((tp_s, fp_s))) == \
        _spec_bytes(pshapes, specs, dist) < D._storage_bytes(
            D._tensors(pshapes))
    trainable, _ = PP.partition(pshapes, TR.trainable_mask_for(cfg, pshapes))
    assert D._storage_bytes(D._tensors((opt_s.mu, opt_s.nu))) == \
        2 * _spec_bytes(trainable, specs, dist)
    assert tuple(rows["tokens"].shape) == (1, 512)
    assert rec["memory"]["argument_bytes"] == D._storage_bytes(
        D._tensors(cell.local_args))
    top, layers = _gathered(pshapes, cfg, 16)
    coll = rec["collective_bytes"]
    assert coll["all-gather"] == top + 2 * layers
    assert coll["reduce-scatter"] == sum(
        x.numel() * x.element_size() // 16 for path, x in
        PP.leaves(trainable) if FS.gather_dim(path, cfg, 16) is not None) > 0
    cell = PS.build_decode_cell(cfg, PS.ShapeSpec("decode", 24, 16), dist)
    rec = D.measure(cell, mesh.counts)
    assert D._storage_bytes(D._tensors(cell.local_args[0])) == \
        _spec_bytes(pshapes, specs, dist)
    assert rec["collective_bytes"]["all-gather"] == top + layers
    assert "reduce-scatter" not in rec["collective_bytes"]


def test_fsdp_variant_record_differs_from_tp(tmp_path):
    """``--variant fsdp`` writes the ZeRO-3 record, no longer the tensor-
    parallel one under the fsdp name: SmolLM-360M's decode on the single
    pod holds other argument bytes and gathers its weights."""
    import json
    args = ["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    D.main(args)
    D.main(args + ["--variant", "fsdp"])
    tp = json.loads((tmp_path / "smollm-360m__decode_32k__single.json")
                    .read_text())
    fs = json.loads((tmp_path / "smollm-360m__decode_32k__single__fsdp.json")
                    .read_text())
    assert fs["memory"]["argument_bytes"] != tp["memory"]["argument_bytes"]
    assert fs["collective_bytes"]["all-gather"] > 0
    assert "all-gather" not in tp["collective_bytes"]


def test_fsdp_ep_variant_record(tmp_path):
    """``--variant fsdp+ep`` writes phi3.5-moe's ZeRO-3 train record
    (ROADMAP item 4b-v-c, done): other argument bytes than ``--variant
    ep``'s, and all-gathers that hold, beside ``--variant fsdp``'s
    weights, each MoE layer's expert ids over its data block, gathered
    over the model axis in the forward and again in the remat
    recompute."""
    arch = "phi3.5-moe-42b-a6.6b"
    args = ["--arch", arch, "--shape", "train_4k", "--mesh", "single",
            "--out", str(tmp_path)]
    rec = {}
    for v in ("ep", "fsdp+ep", "fsdp"):
        D.main(args + ["--variant", v])
        rec[v] = json.loads((tmp_path / f"{arch}__train_4k__single__{v}.json")
                            .read_text())
    assert rec["fsdp+ep"]["memory"]["argument_bytes"] != \
        rec["ep"]["memory"]["argument_bytes"]
    cfg = D._apply_variant(D.get_config(arch), "fsdp+ep")
    dist = PM.make_dist(PM.make_shape_mesh(*PM.PRODUCTION["single"]))
    rows, seq = PS.build_cell(cfg, "train_4k", dist).local_args[3][
        "tokens"].shape                      # this rank's of its data block
    ids = rows * dist.n_model * seq * cfg.top_k * 8             # int64
    gathers = rec["fsdp+ep"]["collective_bytes"]["all-gather"]
    assert dist.n_model > 1 and cfg.remat
    assert gathers - rec["fsdp"]["collective_bytes"]["all-gather"] == \
        cfg.n_layers * 2 * ids


def _reference_record_keys():
    """The keys of the record ``repro/launch/dryrun.py``'s ``run_cell``
    writes, and those of its ``memory`` entry, from its source."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rec" for t in node.targets):
            keys = {k.value: v for k, v in zip(node.value.keys,
                                               node.value.values)}
            mem = {k.value for k in keys["memory"].keys}
            return set(keys), mem
    raise AssertionError("no record in the reference's dry run")


def test_cli_record_has_the_reference_keys(tmp_path):
    """One run of the CLI on one small cell (whisper-tiny's decode on the
    single-pod mesh) into ``tmp_path``."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "all requested dry-run cells passed" in r.stdout
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__single.json")
                     .read_text())
    keys, mem = _reference_record_keys()
    assert keys <= set(rec)
    assert set(rec["memory"]) == mem
    assert {"flops", "bytes accessed"} <= set(rec["cost"])
    assert set(rec["calibrated"]) == {"flops", "bytes", "collective"}
    assert rec["devices"] == 256 and rec["mesh"] == "single"
    assert rec["collective_total"] == sum(rec["collective_bytes"].values())
    assert all(v > 0 for v in rec["memory"].values())
    assert rec["cost"]["flops"] > 0 and rec["calibrated"]["flops"] == \
        rec["cost"]["flops"]
