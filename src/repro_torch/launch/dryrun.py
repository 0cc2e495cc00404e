"""Multi-pod dry run: every (arch x shape x mesh) cell on the ``meta``
device (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory and cost analyses.  The port runs the
cell's step (`launch.specs.build_cell`) as rank 0 of a shape-only
production mesh (`launch.mesh.make_shape_mesh`: 16 x 16, or 2 x 16 x 16)
on its ``meta`` argument tree: every op computes shapes and dtypes and
allocates no data, the mesh's collectives move nothing and count their
bytes, and the kernel ops charge their formulas (`kernels.ops`).  It
touches no CUDA device and sets no ``XLA_FLAGS``.  Per cell it records,
per device:

  - memory: ``argument_bytes`` (what the rank holds of the cell's
    arguments) and ``output_bytes`` (its results), exactly;
    ``temp_bytes`` and ``peak_bytes`` from a live-bytes tracker over the
    meta run (each new storage's bytes added when an op returns it, taken
    off when it dies), an estimate of what the caching allocator holds;
  - cost: ``flops``, the aten matmuls (``FlopCounterMode``) and the
    kernel ops' own counts; ``bytes accessed``, the operands and results
    of those same ops (elementwise ops are not counted);
  - collective bytes by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all), the bytes one device receives, as the reference counts
    an HLO collective's result (under ``--variant fsdp`` the per-layer
    all-gathers of the weights and, in training, the reduce-scatters of
    their gradients);
  - ``calibrated``: the same counts.  The reference fits ``base + b L``
    over reduced-depth compiles because XLA counts a scanned layer body
    once; the port runs every layer in Python, so its counts are direct.

Results go to ``experiments/dryrun_torch/*.json`` (resumable; the
reference's ``experiments/dryrun/`` records are never overwritten).

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import PRODUCTION, make_dist, make_shape_mesh
from repro_torch.launch.specs import SHAPES, Cell, build_cell
from repro_torch.obs.clock import perf_counter

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

NOTE = ("per device, rank 0 of a shape-only mesh on the meta device; "
        "temp/peak bytes: live-bytes estimate; bytes accessed: matmul and "
        "kernel-op operands and results only")

VARIANTS = {
    "fsdp": lambda c: c.replace(sharding_strategy="fsdp"),
    "int8kv": lambda c: c.replace(kv_cache_dtype="int8"),
    "noremat": lambda c: c.replace(remat=False),
    "ep": lambda c: c.replace(moe_impl="ep"),
    "merge": lambda c: c.replace(ccm=dataclasses.replace(c.ccm,
                                                         mode="merge")),
    # CCM compressed serving (paper Eq. 3): bounded cache + memory instead
    # of the full-length KV cache
    "ccmserve": lambda c: c.replace(serve_cache_len=4096),
}


def _apply_variant(cfg, variant):
    if not variant:
        return cfg
    for v in variant.split("+"):
        cfg = VARIANTS[v](cfg)
    return cfg


def _tensors(tree):
    """The tensor leaves of a tree of dicts, tuples and named tuples."""
    return [x for x in tree_leaves(tree, is_leaf=lambda x: x is None)
            if isinstance(x, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _LiveBytes(TorchDispatchMode):
    """Live bytes over a run: each storage an op returns that is not yet
    known is added, and taken off by a finalizer when it dies; ``peak`` is
    their most at once.  Storages known at the start (the arguments) are
    never counted.  Also the bytes the FLOP-counted ops (matmuls, the
    ``flop_registry`` of ``FlopCounterMode``) read and write."""

    def __init__(self, known):
        super().__init__()
        self.live = self.peak = self.matmul_bytes = 0
        self._known = {t.untyped_storage()._cdata for t in known}

    def _free(self, key, n):
        self.live -= n
        self._known.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if func.overloadpacket in flop_registry:
            self.matmul_bytes += sum(t.numel() * t.element_size() for t in
                                     _tensors((args, kwargs)) + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._known:
                self._known.add(key)
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)
        return out


def measure(cell: Cell, counts: Optional[Dict[str, int]] = None
            ) -> Dict[str, Any]:
    """Run ``cell.fn`` on its meta arguments and count, per device: memory,
    FLOPs and bytes (``memory``, ``cost``, ``kernels``: the kernel ops'
    [calls, FLOPs, bytes] by name), and with ``counts`` (the shape-only
    mesh's collective counter, zeroed here) the collective bytes."""
    if counts is not None:
        counts.clear()
    arg_bytes = _storage_bytes(_tensors(cell.local_args))
    args = _tensors(cell.args)
    live = _LiveBytes(args)
    with ops.count_kernels() as kc, FlopCounterMode(display=False) as fc, \
            live:
        out = cell.fn(*cell.args)
    outs = _tensors(out)
    out_bytes = _storage_bytes(outs)
    # the results the step allocated (not its arguments written in place)
    known = {a.untyped_storage()._cdata for a in args}
    new_out = _storage_bytes([t for t in outs
                              if t.untyped_storage()._cdata not in known])
    colls = dict(counts or {})
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(live.peak - new_out, 0),
                   "peak_bytes": arg_bytes + live.peak},
        "cost": {"flops": float(fc.get_total_flops()) + kc.flops,
                 "bytes accessed": float(live.matmul_bytes) + kc.bytes},
        "kernels": {k: list(v) for k, v in kc.by_op.items()},
        "collective_bytes": colls,
        "collective_total": sum(colls.values()),
    }


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str,
             force: bool = False, variant=None) -> Dict[str, Any]:
    tag = f"__{variant}" if variant else ""
    fname = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{tag}.json")
    if os.path.exists(fname) and not force:
        print(f"skip {arch} {shape} {mesh_kind} (cached)")
        with open(fname) as f:
            return json.load(f)
    t0 = perf_counter()
    mesh = make_shape_mesh(*PRODUCTION[mesh_kind])
    dist = make_dist(mesh)
    cfg = _apply_variant(get_config(arch), variant)
    cell = build_cell(cfg, shape, dist)
    t_lower = perf_counter() - t0
    got = measure(cell, mesh.counts)
    t_compile = perf_counter() - t0 - t_lower
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "variant": variant,
        "devices": mesh.size,
        "note": f"{cell.note}; {NOTE}",
        "lower_s": t_lower, "compile_s": t_compile,
        **got,
        # direct counts: every layer runs (no scan body counted once)
        "calibrated": {"flops": got["cost"]["flops"],
                       "bytes": got["cost"]["bytes accessed"],
                       "collective": float(got["collective_total"])},
        "n_params": get_config(arch).param_count(),
        "n_params_active": get_config(arch).param_count(active_only=True),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"DONE {arch} {shape} {mesh_kind}: build {t_lower:.2f}s "
          f"run {t_compile:.2f}s flops={rec['cost']['flops']:.4g} "
          f"coll={rec['collective_total'] / 1e6:.1f}MB "
          f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="'+'-joined cfg variants: fsdp,int8kv,noremat,ep,"
                         "merge,ccmserve")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                try:
                    run_cell(arch, shape, mk, args.out, force=args.force,
                             variant=args.variant)
                except Exception:
                    failures.append((arch, shape, mk))
                    print(f"FAIL {arch} {shape} {mk}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:", failures)
        sys.exit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
