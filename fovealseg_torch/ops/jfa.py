"""Jump flood: every pixel gets its nearest valid seed's payload or flat
index (counterparts of ``fovealseg_tpu/ops/pallas_jfa.py``'s four modes).

=========================  ========================================  ====
wrapper                    TPU entry point                           #
=========================  ========================================  ====
``nearest_class``          ``nearest_class_pallas`` ('class')        K1
``nearest_payload_packed`` ``nearest_payload_packed_pallas``         K2
``nearest_payload``        ``nearest_payload_pallas`` ('payload')    K3
``nearest_seed``           ``nearest_seed_pallas`` ('seed')          K4
=========================  ========================================  ====

Each wrapper calls its registered operator, ``torch.ops.fovealseg.<wrapper>``
(``ops/library.py``), whose CUDA kernel launches the hand-written CUDA kernel
(``fovealseg_torch/csrc/jfa.cu``) and whose CPU kernel is the plain PyTorch
version (``*_plain``); a trace (``torch.export``) records the operator
through its fake kernel. ``rounds`` crosses the operator as one int32
value; the wrapper makes ``None`` and ints into one. All reproduce the
Pallas kernel bit for bit: ``rounds`` clipped to [1, full] with
full = ceil(log2(max(H, W))), rounds+1 trips with step
``max((1 << (rounds-1)) >> i, 1)``, the 8 directions applied in sequence
within a trip, out-of-range candidates invalid, strict ``<`` on the squared
integer distance, 0 where no seed exists. The modes differ only in what is
read at the winning seed, so one flood serves them all. The kernel runs one
launch per trip, all 8 directions in shared memory on tiles of the stride-k
sublattice (``tile_shape``); ``tests/test_torch_port_jfa.py`` emulates its
tiles on the CPU.

Each kernel's launch count is ``<wrapper>.launches``: one per call that
launched it, counted in the operator's CUDA kernel, so the run of an exported
program counts as an eager call does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from fovealseg_torch.ops.library import register

_FAR = 2**31 - 1
_MAX_SIDE = 1 << 15  # positions ride as (y << 16) | x in one int32
# The TPU's 'relpay' mode packs a payload of up to 13 bits beside two 9-bit
# offsets and is exact for at most 7 rounds (pallas_jfa.py REL_MAX_ROUNDS)
REL_MAX_PAY_BITS = 13
REL_MAX_ROUNDS = 7


def full_rounds(h: int, w: int) -> int:
    """The full jump-flood round count of an H x W canvas."""
    return max(1, math.ceil(math.log2(max(h, w))))


# The CUDA flood's tiles (Ry, Rx, TA, TB, halo), mirrored by csrc/jfa.cu's
# tile(): each step's own tiles (halo 3) by log2(k), k >= 32 sharing the last
# of them, then whole-class tiles (halo 1) for where a class fits the window.
TILES = ((1, 1, 72, 92, 3), (1, 2, 40, 80, 3), (1, 4, 32, 40, 3), (1, 8, 16, 40, 3),
         (1, 16, 13, 20, 3), (1, 32, 10, 10, 3),
         (4, 32, 5, 5, 1), (1, 32, 10, 10, 1), (1, 8, 20, 20, 1), (1, 4, 40, 40, 1))
OWN_TILES = 6
THREADS = 1024  # the kernel's block: a tile's cells are taken in whole rounds of it
# A residue class whose extent is at most one of these is flooded whole by
# one thread, in registers
REGISTER_CLASSES = (2, 3)


def _tile_cost(tile, k: int, h: int, w: int) -> int | None:
    """Cells one image's trip computes with ``tile``, None where it does not
    apply (more classes than the step has, or a halo-1 window short of a
    class)."""
    ry, rx, ta, tb, halo = tile
    ea, eb = -(-h // k), -(-w // k)
    if ry > k or rx > k or (halo == 1 and (ta < ea or tb < eb)):
        return None
    tiles = -(-min(k, h) // ry) * -(-min(k, w) // rx) * -(-ea // ta) * -(-eb // tb)
    return tiles * -(-ry * rx * (ta + 2 * halo) * (tb + 2 * halo) // THREADS) * THREADS


def tile_shape(k: int, h: int, w: int) -> tuple[int, int, int, int, int]:
    """(Ry, Rx, TA, TB, halo) of one trip's tiles at step k on an H x W
    canvas: blocks of Ry x Rx residue classes mod k, each a TA x TB window of
    its stride-k sublattice with a halo of 3 cells, or of 1 where the window
    holds the whole class. The cheapest that applies, the step's own on a
    tie; a class flooded whole by one thread is (1, 1, E, E, 1)."""
    extent = -(-max(h, w) // k)
    for e in REGISTER_CLASSES:
        if extent <= e:
            return 1, 1, e, e, 1
    best = TILES[min(k.bit_length() - 1, OWN_TILES - 1)]
    cost = _tile_cost(best, k, h, w)
    for tile in TILES[OWN_TILES:]:
        c = _tile_cost(tile, k, h, w)
        if c is not None and c < cost:
            best, cost = tile, c
    return best


def _check(valid: torch.Tensor, payload: torch.Tensor | None = None, cls_bits: int | None = None,
           pay_bits: int | None = None) -> None:
    if valid.dtype != torch.bool or valid.dim() != 3:
        raise ValueError(f"valid must be [B, H, W] bool, got {tuple(valid.shape)} {valid.dtype}")
    if payload is not None:
        if payload.dtype != torch.int32 or payload.shape != valid.shape:
            raise ValueError(f"payload must be int32 of shape {tuple(valid.shape)}, "
                             f"got {tuple(payload.shape)} {payload.dtype}")
        if payload.device != valid.device:
            raise ValueError("valid and payload must be on one device")
    if cls_bits is not None and not 0 < cls_bits < 31:
        raise ValueError(f"cls_bits must be in [1, 30], got {cls_bits}")
    if pay_bits is not None and not 0 < pay_bits < 32:
        raise ValueError(f"pay_bits must be in [1, 31], got {pay_bits}")


def _host_rounds(rounds, full: int) -> int:
    r = full if rounds is None else int(rounds)
    return min(max(r, 1), full)


def _shift(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[:, r, c] = x[:, r + dy, c + dx] where that lies on the canvas, else fill."""
    _, h, w = x.shape
    out = torch.full_like(x, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[:, max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        x[:, max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


def _flood_plain(valid: torch.Tensor, rounds) -> tuple[torch.Tensor, torch.Tensor]:
    """(seed_y, seed_x) [B, H, W] int32 of each pixel's winning seed, -1
    where none is reached."""
    _, h, w = valid.shape
    r = _host_rounds(rounds, full_rounds(h, w))
    dev = valid.device
    ys = torch.arange(h, dtype=torch.int32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, w)
    seed_y = torch.where(valid, ys, -1)
    seed_x = torch.where(valid, xs, -1)
    best = torch.where(valid, 0, _FAR).to(torch.int32)
    for i in range(r + 1):
        k = max((1 << (r - 1)) >> i, 1)
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                if sy == 0 and sx == 0:
                    continue
                cy = _shift(seed_y, sy * k, sx * k, -1)
                cx = _shift(seed_x, sy * k, sx * k, -1)
                d = (cy - ys) * (cy - ys) + (cx - xs) * (cx - xs)
                better = (cy >= 0) & (d < best)
                seed_y = torch.where(better, cy, seed_y)
                seed_x = torch.where(better, cx, seed_x)
                best = torch.where(better, d, best)
    return seed_y, seed_x


def _payload_at_seed(valid, payload, rounds) -> torch.Tensor:
    b, h, w = valid.shape
    seed_y, seed_x = _flood_plain(valid, rounds)
    flat = (seed_y.clamp(min=0) * w + seed_x.clamp(min=0)).reshape(b, h * w).long()
    out = torch.gather(payload.reshape(b, h * w), 1, flat).reshape(b, h, w)
    return torch.where(seed_y >= 0, out, 0)


def nearest_class_plain(valid: torch.Tensor, payload: torch.Tensor, cls_bits: int,
                        rounds=None) -> torch.Tensor:
    """Plain PyTorch version of K1, on CPU or CUDA tensors.

    ``rounds`` is None (full), an int, or an int32 tensor holding one value
    (read to the host here: this version is the reference, not the path)."""
    _check(valid, payload, cls_bits)
    return _payload_at_seed(valid, payload, rounds)


def nearest_payload_plain(valid: torch.Tensor, payload: torch.Tensor, rounds=None) -> torch.Tensor:
    """Plain PyTorch version of K3 (any int32 payload)."""
    _check(valid, payload)
    return _payload_at_seed(valid, payload, rounds)


def nearest_payload_packed_plain(valid: torch.Tensor, payload: torch.Tensor, pay_bits: int,
                                 rounds=None) -> torch.Tensor:
    """Plain PyTorch version of K2 (payload < 2**pay_bits). The Pallas
    kernel's relative-offset packing and its fallback to 'payload' mode
    past 7 rounds give the same winners as K3, so this is K3's function."""
    _check(valid, payload, pay_bits=pay_bits)
    return _payload_at_seed(valid, payload, rounds)


def nearest_seed_plain(valid: torch.Tensor, rounds=None) -> torch.Tensor:
    """Plain PyTorch version of K4: flat index y*W + x of each pixel's
    nearest valid seed, 0 where none is reached."""
    _check(valid)
    return _seed_cpu(valid, rounds)


def _rounds_tensor(rounds, full: int, device: torch.device) -> torch.Tensor:
    """The round count as the ops take it: one int32 value on ``device``.
    None is the full chain; an int (or a CPU tensor, for the plain versions)
    is made into one; a CUDA tensor must already be one int32 value there."""
    if rounds is None:
        rounds = full
    if not torch.is_tensor(rounds):
        return torch.full((1,), int(rounds), dtype=torch.int32, device=device)
    if device.type == "cpu" and rounds.device.type == "cpu" and rounds.numel() == 1:
        return rounds.reshape(1).to(torch.int32)
    if rounds.dtype != torch.int32 or rounds.numel() != 1 or rounds.device != device:
        raise ValueError("rounds must be an int or one int32 value on the kernel's device")
    return rounds.reshape(1).contiguous()


def _launch(entry: str, valid: torch.Tensor, payload: torch.Tensor | None, rounds: torch.Tensor,
            name: str) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/jfa.cu`` on CUDA tensors; raise on what it
    does not take or if the launch fails."""
    b, h, w = valid.shape
    if h >= _MAX_SIDE or w >= _MAX_SIDE or b >= 65536:
        raise ValueError(f"canvas {b}x{h}x{w} exceeds the kernel's limits")
    if not valid.is_contiguous() or (payload is not None and not payload.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    full = full_rounds(h, w)
    r = _rounds_tensor(rounds, full, valid.device)
    out = torch.empty((b, h, w), dtype=torch.int32, device=valid.device)
    scratch = torch.empty_like(out)
    with torch.cuda.device(valid.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [valid.data_ptr()] + ([payload.data_ptr()] if payload is not None else [])
        err = _kernel(entry, len(ptrs))(*ptrs, out.data_ptr(), scratch.data_ptr(), r.data_ptr(),
                                         b, h, w, full, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    return out


# The four floods as registered operators: the CUDA kernel counts its
# launches, so that a program exported with ``torch.export`` counts them too.

def _flood_fake(valid, *_):
    return valid.new_empty(valid.shape, dtype=torch.int32)


def _payload_op(name: str):
    """``fovealseg::<name>`` (valid, payload, rounds) -> int32, counted on
    the wrapper of the same name."""
    def cuda(valid, payload, rounds):
        out = _launch("fovealseg_jfa_nearest_payload", valid, payload, rounds, name)
        globals()[name].launches += 1
        return out

    return register(f"{name}(Tensor valid, Tensor payload, Tensor rounds) -> Tensor",
                    _payload_at_seed, cuda, _flood_fake)


def _seed_cpu(valid: torch.Tensor, rounds: torch.Tensor) -> torch.Tensor:
    w = valid.shape[2]
    seed_y, seed_x = _flood_plain(valid, rounds)
    return torch.where(seed_y >= 0, seed_y * w + seed_x, 0)


def _seed_cuda(valid: torch.Tensor, rounds: torch.Tensor) -> torch.Tensor:
    out = _launch("fovealseg_jfa_nearest_seed", valid, None, rounds, "nearest_seed")
    nearest_seed.launches += 1
    return out


_nearest_class_op = _payload_op("nearest_class")
_nearest_payload_op = _payload_op("nearest_payload")
_nearest_packed_op = _payload_op("nearest_payload_packed")
_nearest_seed_op = register("nearest_seed(Tensor valid, Tensor rounds) -> Tensor", _seed_cpu,
                            _seed_cuda, _flood_fake)


def _rounds_for(valid: torch.Tensor, rounds) -> torch.Tensor:
    return _rounds_tensor(rounds, full_rounds(*valid.shape[1:]), valid.device)


def nearest_class(valid: torch.Tensor, payload: torch.Tensor, cls_bits: int,
                  rounds=None) -> torch.Tensor:
    """K1. valid [B, H, W] bool, payload [B, H, W] int32 (values <
    2**cls_bits) -> [B, H, W] int32 payload of each pixel's nearest valid seed.

    ``rounds``: None (full chain), an int, or an int32 device scalar such as
    ``core.unwarp.jfa_rounds_from_grid``'s, which the kernel reads on the
    device. Calls ``torch.ops.fovealseg.nearest_class``: CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    _check(valid, payload, cls_bits)
    return _nearest_class_op(valid, payload, _rounds_for(valid, rounds))


def nearest_payload(valid: torch.Tensor, payload: torch.Tensor, rounds=None) -> torch.Tensor:
    """K3: as ``nearest_class`` for any int32 payload
    (``torch.ops.fovealseg.nearest_payload``)."""
    _check(valid, payload)
    return _nearest_payload_op(valid, payload, _rounds_for(valid, rounds))


def nearest_payload_packed(valid: torch.Tensor, payload: torch.Tensor, pay_bits: int,
                           rounds=None) -> torch.Tensor:
    """K2: as ``nearest_payload`` for payloads < 2**pay_bits, pay_bits <= 13
    (flat task indices; ``torch.ops.fovealseg.nearest_payload_packed``).
    Dispatches as the Pallas entry point does: a payload wider than 13 bits,
    or a round count known on the host above ``REL_MAX_ROUNDS`` (the TPU
    kernel's ``lax.cond``), goes to K3. A device-scalar count stays here
    without a host sync: the CUDA kernel has no round cap and its winners do
    not depend on the count's side of 7."""
    _check(valid, payload, pay_bits=pay_bits)
    host_r = full_rounds(*valid.shape[1:]) if rounds is None else rounds
    if pay_bits > REL_MAX_PAY_BITS or (isinstance(host_r, int) and host_r > REL_MAX_ROUNDS):
        return nearest_payload(valid, payload, rounds)
    return _nearest_packed_op(valid, payload, _rounds_for(valid, rounds))


def nearest_seed(valid: torch.Tensor, rounds=None) -> torch.Tensor:
    """K4: valid [B, H, W] bool -> [B, H, W] int32 flat index y*W + x of each
    pixel's nearest valid seed, 0 where none is reached
    (``torch.ops.fovealseg.nearest_seed``)."""
    _check(valid)
    return _nearest_seed_op(valid, _rounds_for(valid, rounds))


for _fn in (nearest_class, nearest_payload, nearest_payload_packed, nearest_seed):
    _fn.launches = 0


def _kernel(entry: str, n_inputs: int):
    from fovealseg_torch.ops.build import load

    fn = getattr(load("jfa"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (n_inputs + 3) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
