"""Device slot buffers: the rotating device-resident expert store.

The counterpart of ``repro/core/slots.py``. One ``SlotStore`` per MoE layer
holds ``num_slots + 1`` expert weight sets per weight tensor on the device;
the trailing slot stays all-zeros in every plane and backs the LUT's MISS
sentinel, so the grouped-matmul kernel needs no branch for a miss (a zero
int8 scale, or a zero int4 scale and min, computes 0 as well).

Formats (``repro_torch.quant`` has the bytes-per-expert table):

* unquantized — ``[S+1, D, F]`` in the model's type;
* ``int8`` — symmetric per-output-channel int8 ``[S+1, D, F]`` beside f32
  scales ``[S+1, F]``;
* ``int4`` — two nibbles per byte ``[S+1, D/2, F]`` beside f16 scales and
  mins ``[S+1, D/G, F]``.

The store keeps the packed planes; the grouped-matmul kernel reads them
straight from device memory (``raw_dict``). The host warehouse is quantized
once, when the manager is built (``quantize_experts``), so an upload ships
packed rows: the same bytes the reference lands by quantizing inside each
``write_batch``, since a group never spans two experts.

An upload copies each expert's rows straight from the host warehouse
(pinned memory, whose rows are contiguous) into its slot's rows on the
device, one non-blocking copy per expert and plane on the current stream,
with no gather into a staging buffer (a host memcpy of every byte, which
takes longer than the link). Stream order is what keeps
it safe: a launch queued earlier reads the old slot contents before the copy
overwrites them, so the engine rotates strictly after the step (and any
replay) that reads the previous residency. The warehouse is never written
after it is built, so no copy's source can change under it.

Double-buffered generations (predictive prefetch, ``ensure_shadow``): the
reference keeps a second set of buffers and flips by swapping them, layer by
layer. A CUDA graph bakes in addresses, so here both generations live in one
allocation per plane, rows ``[2 (S + 1), ...]``: generation g is rows
``g (S + 1)`` to ``g (S + 1) + S``, each with its own zero MISS row. The
device LUT points into the live half (``base``), so a flip rewrites only
that layer's LUT rows (the manager does), a catch-up (``sync_shadow_slots``)
is a device-to-device row copy, and the grouped matmul reads ``w[lut[g]]``
unchanged. The LUT's MISS value is the last row of the planes
(``miss_row``), which stays zero in either layout.

Under the tensor (model) axis a store is built for ``shard=(rank, tp)``: it
holds only that rank's slice of the expert width F in every slot
(``w_gate`` / ``w_up`` columns, ``w_down`` rows; ``residency_spec``), and
its warehouse rows are the same slice (:func:`shard_experts`), so an upload
copies a contiguous row of the slice. The slot dimension stays whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.quant import (
    GROUP_SIZE_DEFAULT,
    effective_group,
    int4_tensor_bytes,
    quantize_int4_batch,
)
from repro_torch.quant.int4 import true_div

Params = Dict[str, torch.Tensor]

QUANTIZATIONS = (None, "int8", "int4")


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel (last-dim) int8. w [.., F] -> (q int8, scale f32 [F])."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = true_div(amax, 127.0) + 1e-12
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.reshape(w.shape[-1])


def quantize_int8_batch(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int8`` over a leading expert axis: w [N, .., F] ->
    (q int8 [N, .., F], scale f32 [N, F]), each expert's scales those of
    quantizing it alone."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim() - 1)), keepdim=True)
    scale = true_div(amax, 127.0) + 1e-12
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.reshape(w.shape[0], w.shape[-1])


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q [.., F] int8 with its per-channel scale [F] (or one that broadcasts) -> f32."""
    return q.float() * scale


def quantized_expert_bytes(
    weight_shapes: Dict[str, Tuple[int, ...]],
    quantization: Optional[str],
    dtype_bytes: int = 2,
    group_size: int = GROUP_SIZE_DEFAULT,
) -> int:
    """Exact link bytes of ONE expert under ``quantization`` (the unit the
    feasibility check and the uploads are priced in)."""
    total = 0
    for shape in weight_shapes.values():
        n = int(np.prod(shape))
        if quantization == "int8":
            total += n + shape[-1] * 4
        elif quantization == "int4":
            total += int4_tensor_bytes(shape, group_size)
        else:
            total += n * dtype_bytes
    return total


def plane_layout(
    weight_shapes: Dict[str, Tuple[int, ...]],
    dtype: torch.dtype,
    quantization: Optional[str],
    group_size: int = GROUP_SIZE_DEFAULT,
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """One expert's planes in ``raw_dict`` naming: ``w_*`` plus ``scale_w_*``
    (int8, int4) and ``min_w_*`` (int4), each as (shape, type)."""
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    for name, shape in weight_shapes.items():
        shape = tuple(shape)
        if quantization == "int8":
            out[name] = (shape, torch.int8)
            out[f"scale_{name}"] = ((shape[-1],), torch.float32)
        elif quantization == "int4":
            d, f = shape[-2], shape[-1]
            gshape = shape[:-2] + (d // effective_group(d, group_size), f)
            out[name] = (shape[:-2] + (d // 2, f), torch.uint8)
            out[f"scale_{name}"] = (gshape, torch.float16)
            out[f"min_{name}"] = (gshape, torch.float16)
        else:
            out[name] = (shape, dtype)
    return out


def quantize_experts(
    experts: Params,                  # name -> [E, ..] float, on any device
    quantization: str,
    group_size: int = GROUP_SIZE_DEFAULT,
    device=None,
    chunk: int = 16,
) -> Params:
    """A layer's expert stacks in ``raw_dict`` planes, in host memory (pinned
    when a card is present). ``chunk`` experts at a time are quantized on
    ``device`` (default: where the weights lie), so the f32 intermediates
    stay small. Each expert's bytes equal quantizing it alone."""
    pin = torch.cuda.is_available()
    out: Params = {}
    for name, w in experts.items():
        dev = torch.device(device) if device is not None else w.device
        for i in range(0, w.shape[0], chunk):
            part = w[i:i + chunk].to(dev)
            if quantization == "int8":
                q, scale = quantize_int8_batch(part)
                planes = {name: q, f"scale_{name}": scale}
            elif quantization == "int4":
                q, scale, mn = quantize_int4_batch(part, group_size)
                planes = {name: q, f"scale_{name}": scale, f"min_{name}": mn}
            else:
                raise ValueError(f"unknown quantization {quantization!r}")
            for key, val in planes.items():
                if key not in out:
                    out[key] = torch.empty((w.shape[0],) + tuple(val.shape[1:]),
                                           dtype=val.dtype, pin_memory=pin)
                out[key][i:i + chunk].copy_(val)
    return out


def shard_width(name: str, shape: Tuple[int, ...], rank: int, tp: int) -> Tuple[int, int]:
    """(dimension, [start, stop)) of rank ``rank``'s slice of the expert width
    F in one expert's plane ``name`` of ``shape`` (``w_down`` [F, D]: rows;
    ``w_gate`` / ``w_up`` [D, F]: columns); F must divide by ``tp``."""
    dim = len(shape) - (2 if name == "w_down" else 1)
    f = shape[dim]
    if f % tp:
        raise ValueError(f"{name}: expert width {f} does not split over a tensor axis of {tp}")
    return dim, (rank * f // tp, (rank + 1) * f // tp)


def shard_experts(experts: Params, rank: int, tp: int) -> Params:
    """This rank's F slice of one layer's float expert stacks (``w_gate`` /
    ``w_up`` [E, D, F] by columns, ``w_down`` [E, F, D] by rows), each a
    contiguous copy in host memory, pinned where a card is present: a
    rank's warehouse."""
    pin = torch.cuda.is_available()
    out: Params = {}
    for name, w in experts.items():
        dim, (lo, hi) = shard_width(name, tuple(w.shape[1:]), rank, tp)
        part = w.narrow(dim + 1, lo, hi - lo)
        out[name] = torch.empty(part.shape, dtype=w.dtype, pin_memory=pin).copy_(part)
    return out


class SlotStore:
    """Rotating device-resident buffer for one MoE layer's routed experts:
    one generation of ``num_slots + 1`` rows per plane, or two folded into
    one allocation once ``ensure_shadow`` has run. ``shard=(rank, tp)``:
    each slot holds rank ``rank``'s slice of the expert width (unquantized
    planes only)."""

    def __init__(
        self,
        num_slots: int,
        weight_shapes: Dict[str, Tuple[int, ...]],   # e.g. w_gate: (D, F)
        dtype: torch.dtype,
        device,
        quantization: Optional[str] = None,
        group_size: int = GROUP_SIZE_DEFAULT,
        shard: Optional[Tuple[int, int]] = None,
    ):
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"unknown quantization {quantization!r}")
        if shard is not None:
            if quantization is not None:
                raise ValueError("slots split on the expert width hold unquantized planes only")
            sliced = {}
            for name, shape in weight_shapes.items():
                dim, (lo, hi) = shard_width(name, tuple(shape), *shard)
                sliced[name] = tuple(shape[:dim]) + (hi - lo,) + tuple(shape[dim + 1:])
            weight_shapes = sliced
        self.shard = shard
        self.num_slots = num_slots
        self.dtype = dtype
        self.device = torch.device(device)
        self.generations = 1
        self.live = 0                       # the generation the device LUT points into
        self._layout = plane_layout(weight_shapes, dtype, quantization, group_size)
        self._set_planes({
            key: torch.zeros((num_slots + 1,) + shape, dtype=dt, device=self.device)
            for key, (shape, dt) in self._layout.items()
        })

    def _set_planes(self, planes: Params) -> None:
        names = [n for n in planes if not n.startswith(("scale_", "min_"))]
        self.buffers: Params = {n: planes[n] for n in names}
        self.scales: Params = {n: planes[f"scale_{n}"] for n in names if f"scale_{n}" in planes}
        self.mins: Params = {n: planes[f"min_{n}"] for n in names if f"min_{n}" in planes}

    @property
    def bytes_per_expert(self) -> int:
        """Bytes of one expert over every plane (one slot's row of each)."""
        return sum(int(np.prod(shape)) * dt.itemsize for shape, dt in self._layout.values())

    def base(self, generation: Optional[int] = None) -> int:
        """First row of ``generation`` (default: the live one)."""
        return (self.live if generation is None else generation) * (self.num_slots + 1)

    @property
    def miss_row(self) -> int:
        """The zero row the device LUT names for a non-resident expert: the
        planes' last row (``num_slots`` with one generation)."""
        return self.generations * (self.num_slots + 1) - 1

    def _check_slots(self, slots: Sequence[int]) -> None:
        for slot in slots:
            if not 0 <= slot < self.num_slots:
                raise ValueError(f"slot {slot} out of range [0, {self.num_slots})")

    def _rows(self, slots: Sequence[int], generation: int) -> torch.Tensor:
        self._check_slots(slots)
        rows = np.asarray(slots, np.int64) + self.base(generation)
        return torch.as_tensor(rows).to(self.device, non_blocking=True)

    def write_batch(
        self,
        slots: Sequence[int],
        experts: Dict[str, Sequence[torch.Tensor]],   # raw_dict name -> N host rows
        *,
        shadow: bool = False,
    ) -> int:
        """Upload N experts into ``slots`` of the live generation (or of the
        shadow one): one non-blocking host->device copy per expert and
        plane, on the current stream. ``experts`` holds every plane of
        ``raw_dict`` (packed rows when quantized) as N rows each: views of
        the pinned warehouse, or a stacked [N, ...] tensor. Returns bytes
        moved."""
        if not len(slots):
            return 0
        if shadow and self.generations < 2:
            raise ValueError("shadow write before ensure_shadow()")
        self._check_slots(slots)
        planes = self.raw_dict()
        if set(experts) != set(planes):
            raise ValueError(f"planes {sorted(experts)} do not match the store's {sorted(planes)}")
        base = self.base(1 - self.live if shadow else self.live)
        moved = 0
        for name, rows in experts.items():
            buf = planes[name]
            if len(rows) != len(slots):
                raise ValueError(f"{name}: {len(rows)} rows for {len(slots)} slots")
            for slot, row in zip(slots, rows):
                buf[base + int(slot)].copy_(row, non_blocking=True)
                moved += row.numel() * buf.element_size()
        return moved

    # -- double-buffered generations (predictive prefetch) -----------------
    def ensure_shadow(self) -> None:
        """Fold a shadow generation into every plane: each plane becomes
        ``[2 (S + 1), ...]`` with both halves holding the live contents, so
        the first flip's untouched slots are already correct. The planes are
        reallocated once, here: the engine calls this before it captures a
        step that reads them."""
        if self.generations == 2:
            return
        self._set_planes({name: torch.cat([plane, plane]) for name, plane in self.raw_dict().items()})
        self.generations = 2

    def sync_shadow_slots(self, slots: Sequence[int]) -> int:
        """Device-to-device catch-up: copy ``slots`` rows live -> shadow
        (slots the shadow merely lags on; no host-link traffic), on the
        current stream. Returns dispatches (one per plane)."""
        if not len(slots):
            return 0
        src = self._rows(slots, self.live)
        dst = self._rows(slots, 1 - self.live)
        planes = self.raw_dict()
        for plane in planes.values():
            plane.index_copy_(0, dst, plane.index_select(0, src))
        return len(planes)

    def flip(self) -> None:
        """Generation flip: the corrected shadow becomes live (what the next
        launch reads once the owner rewrites the device LUT); the previous
        live becomes the new, stale shadow."""
        if self.generations < 2:
            raise ValueError("flip() before ensure_shadow()")
        self.live = 1 - self.live

    def generation_view(self, generation: Optional[int] = None) -> Params:
        """``raw_dict`` restricted to one generation's ``num_slots + 1`` rows
        (views; default the live one)."""
        b = self.base(generation)
        return {n: t[b:b + self.num_slots + 1] for n, t in self.raw_dict().items()}

    def raw_dict(self) -> Params:
        """The planes the MoE half reads (every generation; row ``miss_row``
        = zeros): the ``w_*`` buffers plus ``scale_w_*`` / ``min_w_*`` when
        quantized (the reference's ``raw_pytree``)."""
        out = dict(self.buffers)
        for name, s in self.scales.items():
            out[f"scale_{name}"] = s
        for name, m in self.mins.items():
            out[f"min_{name}"] = m
        return out
