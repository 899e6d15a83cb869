"""The port does all the reference package does, name by name.

Every public top-level name of every module of `zprize_tpu/` (a `def`, a
`class` or an assigned name, found by parsing the source with `ast`; the
reference is never imported here) is one of:
- present, under the same name, in the port's module at the same path;
- in `MOVED`, the port's counterpart under another name or path, which
  the test imports;
- in `DROPPED`, with one sentence naming what replaces it.

Another case fails on stale entries: a `MOVED` or `DROPPED` name that the
reference no longer has, or that the port now has at the same path.
"""

import ast
import importlib
import pathlib

import pytest

from zprize_tpu_torch.msm import accum_kernel
from zprize_tpu_torch.ntt import fr_kernel, gl_kernel
from torch_memory import release_memory  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "zprize_tpu"
PORT = ROOT / "zprize_tpu_torch"


def _public_names(path: pathlib.Path) -> set:
    """The public names a module defines at its top level."""
    if not path.exists():
        return set()
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _dotted(path: pathlib.Path) -> str:
    """zprize_tpu/curve/te.py -> "curve.te"."""
    return ".".join(path.relative_to(REF).with_suffix("").parts)


REF_NAMES = {_dotted(p): _public_names(p) for p in sorted(REF.rglob("*.py"))}
REF_NAMES = {m: names for m, names in REF_NAMES.items() if names}


def _port_names(module: str) -> set:
    return _public_names(PORT.joinpath(*module.split(".")).with_suffix(".py"))


# the same capability under another name or path in the port
MOVED = {
    "curve.te.sum_scan": "msm.te_path.sum_axis",
    "curve.te.te_to_sw": "curve.te.te_to_sw_affine",
    "field.fp.from_ints_np": "field.fp.from_ints",
    "marlin.ahp.M_NAMES": "marlin.indexer.M_NAMES",
    "msm.accum_kernel.accumulate_pass_pallas":
        "msm.pippenger.accumulate_pass_all",
    "msm.accum_kernel.accumulate_rect_pallas":
        "msm.pippenger.accumulate_pass_all",
    "msm.accum_kernel.accumulate_te_pallas":
        "msm.accum_kernel.te_gather_accumulate",
    "msm.accum_kernel.accumulate_te_sorted":
        "msm.accum_kernel.te_bucket_accumulate",
    "msm.accum_kernel.combine_te_batch_pallas": "msm.accum_kernel.te_combine",
    "msm.accum_kernel.combine_te_pallas": "msm.accum_kernel.te_combine",
    "msm.accum_kernel.merge_buckets_pallas": "msm.pippenger.merge_buckets_all",
    "msm.accum_kernel.merge_buckets_te_pallas": "msm.te_path.merge_buckets_te",
    "msm.accum_kernel.merge_te_triangle_pallas":
        "msm.te_path.merge_buckets_te_triangle",
    "msm.accum_kernel.te_dbl_chain_pallas": "msm.accum_kernel.te_dbl_chain",
    "msm.te_path.accumulate_te": "msm.accum_kernel.te_gather_accumulate_plain",
    "msm.te_path.finish_te": "msm.te_path.combine_windows_te",
    "msm.te_path.unpack_pre": "curve.te.unpack_pre",
    "ntt.fr_kernel.big_split": "ntt.fr_kernel.plan",
    "ntt.fr_kernel.ntt_core_pallas": "ntt.fr_kernel.fr_ntt",
    "ntt.gl_kernel.MAX_KERNEL_LOG": "ntt.gl_kernel.TILE_LOG",
    "ntt.gl_kernel.Q": "ntt.gl_ops.Q",
    "ntt.gl_ops.from_limbs": "ntt.gl_ops.from_words",
    "ntt.gl_ops.to_limbs": "ntt.gl_ops.to_words",
    "parallel.mesh.make_mesh": "parallel.mesh.spawn_world",
    "parallel.mesh.shard_batch": "parallel.mesh.shard_rows",
    "poly.ops.coeffs_from_ints": "field.fp.from_ints",
    "poly.ops.gpow_np": "poly.ops.gpow",
    "utils.native.lincomb": "pcs.lincomb.lincomb",
    "utils.native.point_chain": "utils.oracle.generator_chain",
    "utils.native.scalar_mul": "utils.oracle.ec_mul",
}

# the reference's Pallas builders: (TPU kernel number, the port's kernel),
# the kernel number being the row of the kernel table in PERF.md §6
BUILDERS = {
    "msm.accum_kernel.make_mixed_add": (1, "sw_gather_accumulate"),
    "msm.accum_kernel.make_full_add": (2, "sw_full_add"),
    "msm.accum_kernel.make_mixed_add_multi": (3, "sw_gather_accumulate"),
    "msm.accum_kernel.make_mixed_add_rect": (4, "sw_gather_accumulate"),
    "msm.accum_kernel.make_te_mixed_add": (5, "te_gather_accumulate"),
    "msm.accum_kernel.make_te_full_add": (6, "te_full_add"),
    "msm.accum_kernel.make_te_dbl_chain": (7, "te_dbl_chain"),
    "msm.accum_kernel.make_te_combine": (8, "te_combine"),
    "msm.accum_kernel.make_te_mixed_add_slab": (9, "te_bucket_accumulate"),
}

_FQ_OP = ("an in-kernel field op of the Pallas engine on limb tiles, whose "
          "counterpart is `csrc/fq.cuh`, the field engine of every MSM and "
          "Fr NTT kernel.")
_FQ_TABLE = ("a constant table the Pallas kernels take for their reduction, "
             "which the Montgomery words of `csrc/fq.cuh` do not need.")
_MXU = ("the TPU MXU schedule of the field multiply, not ported "
        "(ROADMAP.md \"Don't port TPU workarounds\"): `csrc/fq.cuh` "
        "multiplies on IMAD carry chains.")
_U16 = ("the u16-packed column-major table layout chosen for TPU lanes, not "
        "ported (ROADMAP.md \"Don't port TPU workarounds\"): the port's "
        "tables are (n, 3, n_words) rows (`te_path.prepare_points`).")

DROPPED = {
    **{name: (f"the Pallas builder of TPU kernel #{row}, replaced by the "
              f"hand-written `{kernel}` (PERF.md §6 kernel table, row {row}).")
       for name, (row, kernel) in BUILDERS.items()},
    "curve.sw.get_scalar_bit": (
        "bit j of a base-2^15 limb plane; `sw.mul_scalar` reads the bits of "
        "its Montgomery rows itself, and `sw.mul_scalar_int` takes an int."),
    "field.fp.add_many": (
        "one normalisation pass over k redundant limb planes; the port's "
        "Montgomery words are reduced by every `fp.add`, so a sum of k is "
        "k - 1 of them."),
    "field.fp.compact_scalars": (
        "the reference's u16 canonical scalar planes (its 2^26 memory plan), "
        "which the port's MSM API takes as they are."),
    "field.fp.mul_const": (
        "a product by a small int on redundant limbs; the port multiplies by "
        "`fp.constant` words, and its SW kernels add up their products by 3b "
        "(`csrc/msm_sw.cu`)."),
    "field.fp.to_canonical": (
        "reduces redundant limbs into [0, p); the port's words always lie "
        "there, and `fp.from_mont` and `fp.to_ints` give the values."),
    **dict.fromkeys([f"field.fp_kernel.{n}" for n in (
        "kadd", "kconst", "kmul", "kmul_const", "kneg", "kneg_raw", "ksub")],
        _FQ_OP),
    **dict.fromkeys(["field.fp_kernel.fold_table_t",
                     "field.fp_kernel.neg2_col"], _FQ_TABLE),
    **dict.fromkeys([f"field.fp_kernel.{n}" for n in (
        "MXU_N_PIECES", "MXU_PIECE_BITS", "kmul_hybrid", "kmul_mxu",
        "mxu_tables")], _MXU),
    "msm.accum_kernel.SLAB_S": (
        "the rows a step of the TPU slab kernel takes; `te_bucket_accumulate`"
        " walks a bucket's run row by row on one thread (PERF.md §6 kernel "
        "table, row 9)."),
    "msm.accum_kernel.tier_schedule": (
        "the depth tiers that balance TPU lanes (ROADMAP.md Queue 1, "
        "\"Dropped\"); in the port one thread walks a bucket's whole run."),
    **dict.fromkeys([f"msm.te_path.{n}" for n in (
        "pack_u16", "precompute_packed", "unpack_u16")], _U16),
    "ntt.fr_kernel.BIG_MAX_LOG": (
        "a cap on the TPU four-step's prebuilt twiddle matrices; "
        "`fr_kernel.plan` splits every size up to `MAX_LOG` into passes "
        "with no such matrices."),
    "ntt.fr_kernel.MIN_LOG": (
        "the smallest size the reference routes onto its Pallas NTT; "
        "`fr_ntt` takes every size from 2^1 (`fr_kernel.plan`)."),
    "ntt.fr_kernel.enabled": (
        "the TPU switches `ZPRIZE_FR_NTT` and `ZPRIZE_NO_PALLAS`; the port's "
        "wrappers choose the kernel by their tensors' device "
        "(`utils/device.on_card`)."),
    "ntt.fr_kernel.supported": (
        "the reference's routing test for its Pallas NTT; `fr_ntt` takes "
        "every size `fr_kernel.plan` accepts, and `plan` raises beyond."),
    "ntt.gl_ops.add64": (
        "a u64 add with carry-out on the reference's (lo, hi) u32 pairs; the "
        "port's `gl_ops.gl_add` carries on 32-bit pieces of int64 values."),
    "utils.native.CURVE_ID": (
        "the curve numbers of the ctypes interface of the reference's "
        "library; the port's byte form needs none, and `pcs/lincomb.py` has "
        "its own."),
    "utils.native.available": (
        "whether the reference's g++-built library loads; the port's host "
        "C++ (`pcs/lincomb.py`) builds through `utils/build.py` and raises "
        "if it cannot."),
    "utils.native.host_combine_windows": (
        "a window combine on the host; the port combines on the card "
        "(`te_combine` and `sw_combine`, PERF.md §6 kernel table, rows 8 "
        "and 2)."),
}


def _split(qualified: str):
    module, _, name = qualified.rpartition(".")
    return module, name


@pytest.mark.parametrize("module", sorted(REF_NAMES))
def test_every_reference_name_has_its_place_in_the_port(module):
    here = _port_names(module)
    unplaced = []
    for name in sorted(REF_NAMES[module]):
        qualified = f"{module}.{name}"
        if name in here or qualified in DROPPED:
            continue
        if qualified not in MOVED:
            unplaced.append(qualified)
            continue
        target_module, target = _split(MOVED[qualified])
        mod = importlib.import_module(f"zprize_tpu_torch.{target_module}")
        assert hasattr(mod, target), f"{qualified} -> {MOVED[qualified]}"
    assert not unplaced, (f"reference names with no port counterpart, no "
                          f"MOVED target and no DROPPED ground: {unplaced}")


def test_moved_and_dropped_entries_are_current():
    """Each entry names a public name the reference has and the port's
    module at the same path lacks; each ground is one sentence, and each
    builder's kernel is a kernel of the port."""
    assert not MOVED.keys() & DROPPED.keys()
    for qualified in (*MOVED, *DROPPED):
        module, name = _split(qualified)
        assert name in REF_NAMES.get(module, ()), (
            f"{qualified}: not in the reference")
        assert name not in _port_names(module), (
            f"{qualified}: the port has it under the same name")
    for qualified, ground in DROPPED.items():
        assert ground.endswith(".") and ". " not in ground, qualified
    kernels = {*accum_kernel.KERNELS, *fr_kernel.KERNELS, *gl_kernel.KERNELS}
    assert {kernel for _, kernel in BUILDERS.values()} <= kernels
