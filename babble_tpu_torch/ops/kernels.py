"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the build that turns ``csrc/*.cu`` into one shared library.

Every source has a plain C interface. On first use one ``nvcc`` a source,
all started together, compiles them for ``sm_90a``, and one more links the
objects into one library in the git-ignored ``build/kernels/`` directory
beside the package; it is loaded with ``ctypes``.
The library name carries a hash over every source and header under
``csrc/`` and the flags, so an edited source never loads a stale build.

A wrapper takes its plain version only for tensors on the CPU (the tests).
For CUDA tensors it launches the kernel or raises: there is no fallback.
K3's plain version is the ladder in ``ops/verify.py``, whose ``shamir``
takes it for CPU tensors; K3's launchers here take CUDA tensors only.
Each wrapper counts its launches in a ``launches`` attribute, under a lock:
co-located nodes launch from many threads at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_count_lock = threading.Lock()
#: nvcc's -Xptxas -v report (registers, spills) of every kernel in this
#: process's compile; empty when an existing build was loaded
ptxas_report = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> List[str]:
    """The kernel sources (``csrc/*.cu``), in name order."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _so_path() -> str:
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        digest.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read() + b"\0")
    digest.update(" ".join(_FLAGS).encode())
    name = f"libbt_kernels-{digest.hexdigest()[:12]}.so"
    return os.path.join(_BUILD_DIR, name)


def build() -> str:
    """Compile the kernel library (where no build of the current sources
    exists) and load it; returns its path. Raises RuntimeError when nvcc
    fails."""
    global _lib, ptxas_report
    so = _so_path()
    with _lock:
        if _lib is not None:
            return so
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp.{os.getpid()}"
            objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
            try:
                procs = [subprocess.Popen(
                    [_nvcc(), *_FLAGS, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                    for obj, src in zip(objs, _sources())]
                outs = [proc.communicate() for proc in procs]
                for proc, (_, err) in zip(procs, outs):
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc exit {proc.returncode}:\n"
                                           f"{err}")
                link = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", tmp,
                                       *objs], capture_output=True, text=True)
                if link.returncode != 0:
                    raise RuntimeError(f"nvcc link exit {link.returncode}:\n"
                                       f"{link.stderr}")
            finally:
                for obj in objs:
                    if os.path.exists(obj):
                        os.remove(obj)
            ptxas_report = "\n".join(out + err for out, err in outs).strip()
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.bt_member_ss_counts.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.bt_member_ss_counts.restype = ctypes.c_int
        lib.bt_strongly_see.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.bt_strongly_see.restype = ctypes.c_int
        lib.bt_strongly_see_block_at.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.bt_strongly_see_block_at.restype = ctypes.c_int
        lib.bt_ecdsa_shamir.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.bt_ecdsa_shamir.restype = ctypes.c_int
        lib.bt_ecdsa_shamir_group.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
        lib.bt_ecdsa_shamir_group.restype = ctypes.c_int
        lib.bt_field_ops.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.bt_field_ops.restype = ctypes.c_int
        lib.bt_member_ss_tile.argtypes = [ctypes.c_int] * 4
        lib.bt_strongly_see_block_tile.argtypes = [ctypes.c_int] * 3
        lib.bt_ecdsa_group.argtypes = [ctypes.c_int]
        for fn in (lib.bt_member_ss_tile, lib.bt_strongly_see_block_tile,
                   lib.bt_ecdsa_group):
            fn.restype = ctypes.c_int
        _lib = lib
    return so


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


# =============================================================================
# K1: per-peer-set strongly-see counts (csrc/member_ss.cu)
# =============================================================================

#: largest peer axis: the kernels count in float32 registers, exact up to
#: 2^24
MEMBER_SS_MAX_P = 2**24


def member_ss_counts_plain(la: torch.Tensor, fd: torch.Tensor,
                           member: torch.Tensor) -> torch.Tensor:
    """counts[..., s, v, w] = sum_p member[..., s, p] * (la[..., v, p] >=
    fd[..., w, p]), as a broadcast compare masked by membership and summed
    over p — no integer matmul, which CUDA does not have. la [V, P] and fd
    [W, P] give [S, V, W]; a leading batch axis ([B, V, P], [B, W, P])
    gives [B, S, V, W]."""
    ge = la[..., :, None, :] >= fd[..., None, :, :]  # [..., V, W, P]
    return (ge[..., None, :, :, :] & member[..., :, None, None, :]).sum(
        -1, dtype=torch.int32)


def _check_coords(la, fd, rows: str) -> None:
    """Raise unless la and fd are int32 coordinates [n, P] and [m, P] (or
    [B, n, P] and [B, m, P]); ``rows`` names n and m in the message."""
    if la.dtype != torch.int32 or fd.dtype != torch.int32:
        raise TypeError(f"la/fd must be int32, got {la.dtype}/{fd.dtype}")
    if (la.dim() not in (2, 3) or fd.dim() != la.dim()
            or fd.shape[-1] != la.shape[-1]
            or fd.shape[:-2] != la.shape[:-2]):
        n, m = rows
        raise ValueError(
            f"la and fd must be [{n}, P] and [{m}, P], or [B, {n}, P] and "
            f"[B, {m}, P], got {tuple(la.shape)} and {tuple(fd.shape)}"
        )


def _check_member_ss(la, fd, member) -> None:
    _check_coords(la, fd, "VW")
    if member.dtype != torch.bool:
        raise TypeError(f"member must be bool, got {member.dtype}")
    if (member.dim() != la.dim() or member.shape[-1] != la.shape[-1]
            or member.shape[:-2] != la.shape[:-2]):
        want = "[S, P]" if la.dim() == 2 else f"[B={la.shape[0]}, S, P]"
        raise ValueError(
            f"member must be {want} with P={la.shape[-1]}, got "
            f"{tuple(member.shape)}"
        )
    if not (la.device == fd.device == member.device):
        raise ValueError("la, fd and member must be on one device")


def member_ss_counts(la: torch.Tensor, fd: torch.Tensor,
                     member: torch.Tensor) -> torch.Tensor:
    """K1. int32 [S, V, W] strongly-see counts per peer-set slot from la
    [V, P] against fd [W, P] (the live sweep's V = W; a shard of the
    sharded sweep its own V voter rows against all W candidates), or
    [B, S, V, W] from a batch of windows ([B, V, P] and [B, W, P]
    coordinates, [B, S, P] membership) in one launch. CPU tensors take the
    plain version; CUDA tensors launch the kernel, on the current stream of
    their device.

    Both compute the product by ``member`` exactly for every int32 value.
    The JAX package's Pallas kernel folds membership into fd as INT32_MAX
    instead, which agrees wherever la stays below INT32_MAX: K1's domain,
    which last-ancestor indexes never leave."""
    _check_member_ss(la, fd, member)
    if la.device.type == "cpu":
        return member_ss_counts_plain(la, fd, member)
    if la.device.type != "cuda":
        raise ValueError(f"member_ss_counts: unsupported device {la.device}")
    if not (la.is_contiguous() and fd.is_contiguous()
            and member.is_contiguous()):
        raise ValueError("member_ss_counts: inputs must be contiguous")
    *batch, V, P = la.shape
    W = fd.shape[-2]
    B = batch[0] if batch else 1
    S = member.shape[-2]
    if P > MEMBER_SS_MAX_P:
        raise ValueError(
            f"member_ss_counts: P={P} exceeds {MEMBER_SS_MAX_P}, the largest "
            "peer axis the kernel's float32 counters hold exactly"
        )
    groups = S // 2 if S % 2 == 0 else S  # slot groups a window
    if B * groups > 65535 or B * max(V, W) > 2**31 - 1:
        raise ValueError(f"member_ss_counts: batch {B} of {S} slots and "
                         f"{max(V, W)} rows exceeds the grid's 65535 layers "
                         "or int32 rows")
    out = torch.empty((*batch, S, V, W), dtype=torch.int32, device=la.device)
    if V == 0 or W == 0 or S == 0 or B == 0:
        return out
    if _lib is None:
        build()
    with torch.cuda.device(la.device):
        stream = torch.cuda.current_stream(la.device).cuda_stream
        rc = _lib.bt_member_ss_counts(
            la.data_ptr(), fd.data_ptr(), member.data_ptr(), out.data_ptr(),
            B, V, W, P, S, stream,
        )
    _check_launch(rc, "member_ss_counts")
    with _count_lock:
        member_ss_counts.launches += 1
    return out


member_ss_counts.launches = 0


# K1 as an operator of PyTorch's dispatcher,
# torch.ops.babble_tpu_torch.member_ss_counts, so that the scripted fused
# sweep (ops/voting.py) can call it: the dispatcher calls back into
# ``member_ss_counts`` (looked up at each call) for CPU and CUDA tensors.
_OPS = torch.library.Library("babble_tpu_torch", "DEF")
_OPS.define("member_ss_counts(Tensor la, Tensor fd, Tensor member) -> Tensor")
for _key in ("CPU", "CUDA"):
    _OPS.impl("member_ss_counts",
              lambda la, fd, member: member_ss_counts(la, fd, member), _key)


# =============================================================================
# K2: the strongly-see matrix of the DAG pipeline (csrc/strongly_see.cu)
# =============================================================================

#: largest peer axis, as for K1
STRONGLY_SEE_MAX_P = MEMBER_SS_MAX_P
#: the tiles of K2 and its block form, rows x columns of output a block,
#: by the id of the C entries (csrc/strongly_see.cu)
K2_TILES = ("32x32", "64x64", "64x128", "128x128")
#: rows of la the plain version compares at once, bounding its
#: [rows, E, P] intermediate
_PLAIN_ROWS = 512


def strongly_see_plain(la: torch.Tensor, fd: torch.Tensor,
                       super_majority: int) -> torch.Tensor:
    """SS[..., x, y] = #{p : la[..., x, p] >= fd[..., y, p]} >= sm, as a
    broadcast compare summed over p and thresholded, over ``_PLAIN_ROWS``
    rows of x at a time."""
    parts = [
        (la[..., x0:x0 + _PLAIN_ROWS, None, :] >= fd[..., None, :, :])
        .sum(-1, dtype=torch.int32) >= super_majority
        for x0 in range(0, la.shape[-2], _PLAIN_ROWS)
    ]
    if not parts:
        return torch.empty((*la.shape[:-1], fd.shape[-2]), dtype=torch.bool,
                           device=la.device)
    return torch.cat(parts, dim=-2)


def _check_strongly_see(la, fd) -> None:
    if la.dtype != torch.int32 or fd.dtype != torch.int32:
        raise TypeError(f"la/fd must be int32, got {la.dtype}/{fd.dtype}")
    if la.dim() not in (2, 3) or fd.shape != la.shape:
        raise ValueError(
            f"la and fd must both be [E, P] or [B, E, P], got "
            f"{tuple(la.shape)} and {tuple(fd.shape)}"
        )
    if la.device != fd.device:
        raise ValueError("la and fd must be on one device")


def strongly_see(la: torch.Tensor, fd: torch.Tensor,
                 super_majority: int) -> torch.Tensor:
    """K2. bool [E, E] strongly-see matrix from int32 [E, P] coordinates,
    or [B, E, E] from a batch [B, E, P], exact for every int32 value. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check_strongly_see(la, fd)
    sm = int(super_majority)
    if la.device.type == "cpu":
        return strongly_see_plain(la, fd, sm)
    if la.device.type != "cuda":
        raise ValueError(f"strongly_see: unsupported device {la.device}")
    if not (la.is_contiguous() and fd.is_contiguous()):
        raise ValueError("strongly_see: inputs must be contiguous")
    *batch, E, P = la.shape
    B = batch[0] if batch else 1
    if P > STRONGLY_SEE_MAX_P:
        raise ValueError(
            f"strongly_see: P={P} exceeds {STRONGLY_SEE_MAX_P}, the largest "
            "peer axis the kernel's float32 counters hold exactly"
        )
    if B > 65535:
        raise ValueError(f"strongly_see: batch {B} exceeds the grid's 65535")
    out = torch.empty((*batch, E, E), dtype=torch.bool, device=la.device)
    if E == 0 or B == 0:
        return out
    if _lib is None:
        build()
    with torch.cuda.device(la.device):
        stream = torch.cuda.current_stream(la.device).cuda_stream
        rc = _lib.bt_strongly_see(
            la.data_ptr(), fd.data_ptr(), out.data_ptr(), B, E, P, sm, stream,
        )
    _check_launch(rc, "strongly_see")
    with _count_lock:
        strongly_see.launches += 1
    return out


strongly_see.launches = 0


def _check_block(la, fd, out, col0: int) -> tuple:
    """Raise unless K2's block form can take these: int32 la [X, P] and fd
    [Y, P] (or [B, X, P] and [B, Y, P]) on one device, and ``out`` None or
    a bool [X, ldo] (or [B, X, ldo]) there with 0 <= col0 and col0 + Y <=
    ldo. Returns (X, Y, ldo)."""
    _check_coords(la, fd, "XY")
    if la.device != fd.device:
        raise ValueError("la and fd must be on one device")
    X, Y = la.shape[-2], fd.shape[-2]
    if out is None:
        if col0 != 0:
            raise ValueError("a column offset needs an output to write into")
        return X, Y, Y
    if out.dtype != torch.bool:
        raise TypeError(f"out must be bool, got {out.dtype}")
    if (out.dim() != la.dim() or out.shape[:-2] != la.shape[:-2]
            or out.shape[-2] != X):
        raise ValueError(f"out must be [..., X={X}, ldo] over la's batch, "
                         f"got {tuple(out.shape)}")
    ldo = out.shape[-1]
    if col0 < 0 or col0 + Y > ldo:
        raise ValueError(f"columns {col0}..{col0 + Y} do not fit a row of "
                         f"{ldo}")
    if out.device != la.device:
        raise ValueError("out must be on la's device")
    return X, Y, ldo


def strongly_see_block_plain(la: torch.Tensor, fd: torch.Tensor,
                             super_majority: int,
                             out: Optional[torch.Tensor] = None,
                             col0: int = 0) -> torch.Tensor:
    """K2's block form as plain PyTorch: ``strongly_see_plain`` of la's
    rows against fd's, written into columns col0 .. col0 + Y of ``out``
    (a new [..., X, Y] tensor where None). Returns ``out``."""
    X, Y, ldo = _check_block(la, fd, out, col0)
    block = strongly_see_plain(la, fd, int(super_majority))
    if out is None:
        return block
    out[..., col0:col0 + Y] = block
    return out


def strongly_see_block(la: torch.Tensor, fd: torch.Tensor,
                       super_majority: int,
                       out: Optional[torch.Tensor] = None,
                       col0: int = 0) -> torch.Tensor:
    """K2's block form: SS[..., x, col0 + y] = #{p : la[..., x, p] >=
    fd[..., y, p]} >= sm for la [X, P] against fd [Y, P] (or a batch
    [B, X, P], [B, Y, P]), written into columns col0 .. col0 + Y of the
    bool ``out`` ([..., X, ldo], contiguous; a new [..., X, Y] tensor where
    None), so that one ring step fills its column block in place. Returns
    ``out``. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream of their device, at the tile
    ``strongly_see_block_tile`` names. ``strongly_see`` is the square
    form."""
    return _strongly_see_block_at(None, la, fd, super_majority, out, col0)


def _strongly_see_block_at(tile: Optional[str], la: torch.Tensor,
                           fd: torch.Tensor, super_majority: int,
                           out: Optional[torch.Tensor] = None,
                           col0: int = 0) -> torch.Tensor:
    """``strongly_see_block`` at ``tile`` (one of K2_TILES), or at the tile
    the C entry picks where None: the hook by which the card tests and
    chip_smoke hold every tile against the plain version, and time it."""
    if tile is not None and tile not in K2_TILES:
        raise ValueError(f"tile must be one of {K2_TILES}, got {tile!r}")
    X, Y, ldo = _check_block(la, fd, out, col0)
    sm = int(super_majority)
    if la.device.type == "cpu":
        return strongly_see_block_plain(la, fd, sm, out, col0)
    if la.device.type != "cuda":
        raise ValueError(f"strongly_see_block: unsupported device "
                         f"{la.device}")
    if out is None:
        out = torch.empty((*la.shape[:-1], Y), dtype=torch.bool,
                          device=la.device)
    if not (la.is_contiguous() and fd.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("strongly_see_block: inputs and out must be "
                         "contiguous")
    *batch, _, P = la.shape
    B = batch[0] if batch else 1
    if P > STRONGLY_SEE_MAX_P:
        raise ValueError(
            f"strongly_see_block: P={P} exceeds {STRONGLY_SEE_MAX_P}, the "
            "largest peer axis the kernel's float32 counters hold exactly"
        )
    if B > 65535:
        raise ValueError(f"strongly_see_block: batch {B} exceeds the grid's "
                         "65535")
    if X == 0 or Y == 0 or B == 0:
        return out
    if _lib is None:
        build()
    with torch.cuda.device(la.device):
        stream = torch.cuda.current_stream(la.device).cuda_stream
        rc = _lib.bt_strongly_see_block_at(
            -1 if tile is None else K2_TILES.index(tile), la.data_ptr(),
            fd.data_ptr(), out.data_ptr(), B, X, Y, P, sm, ldo, col0, stream,
        )
    _check_launch(rc, "strongly_see_block")
    with _count_lock:
        strongly_see_block.launches += 1
    return out


strongly_see_block.launches = 0


def member_ss_tile(W: int, S: int, B: int = 1,
                   V: Optional[int] = None) -> int:
    """Side of the output tile (32 or 128) K1 takes for B windows of V
    voter rows (W where None) against W candidates and S slots; builds the
    library if needed."""
    if _lib is None:
        build()
    return _lib.bt_member_ss_tile(B, W if V is None else V, W, S)


def strongly_see_tile(E: int, B: int) -> str:
    """The tile (one of K2_TILES) K2 takes at (E, B); builds the library if
    needed."""
    return strongly_see_block_tile(E, E, B)


def strongly_see_block_tile(X: int, Y: int, B: int = 1) -> str:
    """The tile (one of K2_TILES) K2's block form takes for B blocks of X
    rows against Y columns; builds the library if needed."""
    if _lib is None:
        build()
    return K2_TILES[_lib.bt_strongly_see_block_tile(X, Y, B)]


# =============================================================================
# K3: the Shamir ladder of batched ECDSA verification (csrc/ecdsa_verify.cu)
# =============================================================================


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {t.device}")
    if _lib is None:
        build()


def check_ecdsa_inputs(u1, u2, table_x, table_y, table_inf, r, rn,
                       rn_ok) -> None:
    """Raise unless K3's inputs are int32 limbs [B, 16] (u1, u2, r, rn) and
    [B, 4, 16] (the table), bool [B, 4] (table_inf) and [B] (rn_ok), all
    on one device."""
    B = u1.shape[0] if u1.dim() == 2 else -1
    limbs = {"u1": u1, "u2": u2, "r": r, "rn": rn, "table_x": table_x,
             "table_y": table_y}
    for name, t in limbs.items():
        want = (B, 4, 16) if name.startswith("table") else (B, 16)
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 limbs, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    for name, t, want in (("table_inf", table_inf, (B, 4)),
                          ("rn_ok", rn_ok, (B,))):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    devices = {t.device for t in (u1, u2, table_x, table_y, table_inf, r, rn,
                                  rn_ok)}
    if len(devices) != 1:
        raise ValueError(f"K3 inputs on several devices: {devices}")


#: K3's group sizes, lanes of a warp a signature: ``ecdsa_group(B)`` picks
#: one (csrc/ecdsa_verify.cu)
ECDSA_GROUPS = (1, 4)


def _check_group(group: int, B: int) -> None:
    if group not in ECDSA_GROUPS:
        raise ValueError(f"group must be one of {ECDSA_GROUPS}, got {group}")
    if B * group > 2**31 - 1 - 128:
        raise ValueError(f"batch {B} at group {group} exceeds the grid's "
                         "int32 lanes")


def ecdsa_group(B: int) -> int:
    """Lanes a signature (one of ECDSA_GROUPS) K3 takes for a batch of B;
    builds the library if needed."""
    if _lib is None:
        build()
    return _lib.bt_ecdsa_group(B)


def ecdsa_shamir(u1, u2, table_x, table_y, table_inf, r, rn,
                 rn_ok) -> torch.Tensor:
    """K3 on CUDA tensors: [B] bool, whether x(u1 G + u2 Q) = r (mod n),
    for limbs in [0, 2^16), at ``ecdsa_group(B)`` lanes a signature.
    ``ops.verify.shamir`` takes the plain version for CPU tensors; this
    launches the kernel or raises."""
    return _ecdsa_shamir_at(None, u1, u2, table_x, table_y, table_inf, r, rn,
                            rn_ok)


def _ecdsa_shamir_at(group: Optional[int], *args) -> torch.Tensor:
    """``ecdsa_shamir`` at ``group`` lanes a signature (one of
    ECDSA_GROUPS), or at the group the C entry picks where None: the hook
    by which the card tests and chip_smoke hold each group size against the
    plain ladder, and time it."""
    check_ecdsa_inputs(*args)
    u1 = args[0]
    _on_card(u1, "ecdsa_shamir")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("ecdsa_shamir: inputs must be contiguous")
    B = u1.shape[0]
    out = torch.empty(B, dtype=torch.bool, device=u1.device)
    if B == 0:
        return out
    ptrs = [t.data_ptr() for t in args] + [out.data_ptr(), B]
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream(u1.device).cuda_stream
        if group is None:  # the C entry picks, and refuses what overflows
            rc = _lib.bt_ecdsa_shamir(*ptrs, stream)
        else:
            _check_group(group, B)
            rc = _lib.bt_ecdsa_shamir_group(group, *ptrs, stream)
    _check_launch(rc, "ecdsa_shamir")
    with _count_lock:
        ecdsa_shamir.launches += 1
    return out


ecdsa_shamir.launches = 0

#: bt_field_ops' operation codes
FIELD_OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3}


def field_ops(op: str, a: torch.Tensor, b: torch.Tensor,
              group: int) -> torch.Tensor:
    """A test entry on K3's cooperative field layer: int32 [B, 16] limbs of
    a * b, a^2, a + b or a - b mod p (``op`` a key of FIELD_OPS; b is read
    but unused for "sqr"), computed on the card by groups of ``group``
    lanes (one of ECDSA_GROUPS) a pair. CUDA tensors only."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"field_ops: limbs must be int32, got {a.dtype}/"
                        f"{b.dtype}")
    if a.dim() != 2 or a.shape[1] != 16 or b.shape != a.shape:
        raise ValueError(f"field_ops: a and b must both be [B, 16], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("field_ops: inputs must be contiguous")
    if a.device != b.device:
        raise ValueError("field_ops: a and b must be on one device")
    _check_group(group, a.shape[0])
    _on_card(a, "field_ops")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib.bt_field_ops(group, FIELD_OPS[op], a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), a.shape[0],
                               stream)
    _check_launch(rc, "field_ops")
    with _count_lock:
        field_ops.launches += 1
    return out


field_ops.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    with _count_lock:
        member_ss_counts.launches = 0
        strongly_see.launches = 0
        strongly_see_block.launches = 0
        ecdsa_shamir.launches = 0
        field_ops.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launch count per kernel wrapper."""
    return {"member_ss_counts": member_ss_counts.launches,
            "strongly_see": strongly_see.launches,
            "strongly_see_block": strongly_see_block.launches,
            "ecdsa_shamir": ecdsa_shamir.launches,
            "field_ops": field_ops.launches}
