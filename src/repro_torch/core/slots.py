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

An upload gathers the experts' rows from the host warehouse (pinned memory)
into a pinned staging tensor, copies it to the device without blocking, and
lands it with ONE ``index_copy_`` per plane, all on the current stream.
Stream order is what keeps it safe: a launch queued earlier reads the old
slot contents before the copy overwrites them, so the engine rotates
strictly after the step (and any replay) that reads the previous residency.
PyTorch's pinned-memory allocator keeps each staging block alive until its
copy has run.
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


def gather_rows(host: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """host[rows] into a fresh staging tensor, pinned when a card is present."""
    idx = torch.as_tensor(np.asarray(rows, np.int64))
    out = torch.empty((len(idx),) + tuple(host.shape[1:]), dtype=host.dtype,
                      pin_memory=torch.cuda.is_available())
    torch.index_select(host, 0, idx, out=out)
    return out


class SlotStore:
    """Rotating device-resident buffer for one MoE layer's routed experts."""

    def __init__(
        self,
        num_slots: int,
        weight_shapes: Dict[str, Tuple[int, ...]],   # e.g. w_gate: (D, F)
        dtype: torch.dtype,
        device,
        quantization: Optional[str] = None,
        group_size: int = GROUP_SIZE_DEFAULT,
    ):
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"unknown quantization {quantization!r}")
        self.num_slots = num_slots
        self.dtype = dtype
        self.device = torch.device(device)
        planes = {
            key: torch.zeros((num_slots + 1,) + shape, dtype=dt, device=self.device)
            for key, (shape, dt) in plane_layout(weight_shapes, dtype, quantization,
                                                 group_size).items()
        }
        self.buffers: Params = {n: planes[n] for n in weight_shapes}
        self.scales: Params = {n: planes[f"scale_{n}"] for n in weight_shapes
                               if f"scale_{n}" in planes}
        self.mins: Params = {n: planes[f"min_{n}"] for n in weight_shapes
                             if f"min_{n}" in planes}

    def write_batch(
        self,
        slots: Sequence[int],
        stacked: Dict[str, torch.Tensor],   # raw_dict name -> [N, ...] host rows
    ) -> int:
        """Upload N experts into ``slots``: one non-blocking host->device copy
        and one ``index_copy_`` per plane. ``stacked`` holds every plane of
        ``raw_dict`` (packed rows when quantized). Returns bytes moved."""
        if not len(slots):
            return 0
        for slot in slots:
            if not 0 <= slot < self.num_slots:
                raise ValueError(f"slot {slot} out of range [0, {self.num_slots})")
        planes = self.raw_dict()
        if set(stacked) != set(planes):
            raise ValueError(f"planes {sorted(stacked)} do not match the store's {sorted(planes)}")
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(self.device, non_blocking=True)
        moved = 0
        for name, rows in stacked.items():
            buf = planes[name]
            src = rows.to(device=self.device, dtype=buf.dtype, non_blocking=True)
            buf.index_copy_(0, idx, src)
            moved += int(src.numel()) * src.element_size()
        return moved

    def raw_dict(self) -> Params:
        """The planes the MoE half reads (slot ``num_slots`` = zeros): the
        ``w_*`` buffers plus ``scale_w_*`` / ``min_w_*`` when quantized (the
        reference's ``raw_pytree``)."""
        out = dict(self.buffers)
        for name, s in self.scales.items():
            out[f"scale_{name}"] = s
        for name, m in self.mins.items():
            out[f"min_{name}"] = m
        return out
