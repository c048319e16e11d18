"""Device-resident reference ring: the tick's data path.

Each streamed `WeightedTrajectoryPoint` is packed into ONE flat numeric row
exactly once on append; the per-tick work is

    host:   memcpy of the (typically one) new row into a staging ring
    device: ship the new rows (one `index_copy_`), gather the horizon rows at
            the multi-resolution offsets, slice them back into refs tensors

so a tick has no per-point Python work. Port of the JAX package's
`mpc/ring.py`; the row layout is derived from the ProblemSpec with the same
field conventions. Unlike the JAX ring, the device ring is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import RobotModel
from ..ocp.spec import ProblemSpec
from .buffer import DTFactorsNSeq, TrajectoryBuffer, WeightedTrajectoryPoint

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class RowField:
    key: str      # refs-dict key this field feeds
    offset: int
    size: int


class RowLayout:
    """Flat per-point row layout for a ProblemSpec's runtime references."""

    def __init__(self, spec: ProblemSpec, model: RobotModel):
        self.spec = spec
        self.model = model
        nxs = spec.state_dim(model)
        nv = model.nv
        fields: List[RowField] = []
        off = 0

        def add(key, size):
            nonlocal off
            fields.append(RowField(key, off, size))
            off += size

        add("id", 1)
        add("xref", nxs)
        add("w_x", nxs)
        add("uref", nv)
        add("w_u", nv)
        add("w_coll", 1)
        self._frames: List[str] = []
        self._vel_frames: List[str] = []
        for item in spec.all_costs():
            if item.kind in ("frame_placement", "frame_translation",
                             "frame_rotation", "visual_servoing"):
                if item.frame not in self._frames:
                    self._frames.append(item.frame)
            elif item.kind == "frame_velocity":
                if item.frame not in self._vel_frames:
                    self._vel_frames.append(item.frame)
        for f in self._frames:
            add(f"ee_rot:{f}", 9)
            add(f"ee_trans:{f}", 3)
            add(f"w_ee:{f}", 6)
        for f in self._vel_frames:
            add(f"ee_vel:{f}", 6)
            add(f"w_ee_vel:{f}", 6)
        if spec.soft_contact is not None:
            raise NotImplementedError(
                "soft contact is not ported yet (ROADMAP queue 1, slice 12)")
        self.fields = tuple(fields)
        self.width = off
        self._by_key = {f.key: f for f in fields}
        self._nxs = nxs
        self._nv = nv

    # -- host side -------------------------------------------------------
    def pack_point(self, wp: WeightedTrajectoryPoint,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Flatten one weighted point into a row (numpy, no device work).

        EE weight 6-vectors arrive wire-ordered [trans(3), rot(3)] and are
        stored twist-ordered [rot, trans]; single-EE dicts match any frame.
        """
        row = out if out is not None else np.zeros(self.width, np.float64)
        row[:] = 0.0
        f = self._by_key
        pt, w = wp.point, wp.weights

        def put(key, val):
            fl = f[key]
            row[fl.offset:fl.offset + fl.size] = np.asarray(val).reshape(-1)

        put("id", -1.0 if pt.id is None else float(pt.id))
        x = pt.robot_state
        if len(x) < self._nxs:
            x = np.concatenate([x, np.zeros(self._nxs - len(x))])
        put("xref", x)
        wx = w.w_robot_state
        if len(wx) < self._nxs:
            wx = np.concatenate([wx, np.zeros(self._nxs - len(wx))])
        put("w_x", wx)
        if pt.robot_effort is not None:
            put("uref", pt.robot_effort)
        if w.w_robot_effort is not None:
            put("w_u", w.w_robot_effort)
        if w.w_collision_avoidance is not None:
            put("w_coll", w.w_collision_avoidance)

        def ee_entry(dct, frame):
            if dct is None:
                return None
            if frame in dct:
                return dct[frame]
            if len(dct) == 1:
                return next(iter(dct.values()))
            return None

        for frame in self._frames:
            pose = ee_entry(pt.end_effector_poses, frame)
            if pose is not None:
                put(f"ee_rot:{frame}", pose[0])
                put(f"ee_trans:{frame}", pose[1])
            else:
                put(f"ee_rot:{frame}", np.eye(3))
            wv = ee_entry(w.w_end_effector_poses, frame)
            if wv is not None:
                wv = np.asarray(wv)
                put(f"w_ee:{frame}", np.concatenate([wv[3:], wv[:3]]))
        for frame in self._vel_frames:
            vv = ee_entry(pt.end_effector_velocities, frame)
            if vv is not None:
                put(f"ee_vel:{frame}", vv)
            wv = ee_entry(w.w_end_effector_velocities, frame)
            if wv is not None:
                wv = np.asarray(wv)
                put(f"w_ee_vel:{frame}", np.concatenate([wv[3:], wv[:3]]))
        return row

    # -- device side -----------------------------------------------------
    def unpack_refs(self, rows: torch.Tensor, base_refs: Dict) -> Dict:
        """rows [T+1, width] -> refs dict of views. Keys not covered by the
        row layout pass through from ``base_refs``."""
        refs = dict(base_refs)
        f = self._by_key

        def get(key):
            fl = f[key]
            return rows[:, fl.offset:fl.offset + fl.size]

        refs["xref"] = get("xref")
        refs["w_x"] = get("w_x")
        refs["uref"] = get("uref")
        refs["w_u"] = get("w_u")
        refs["w_coll"] = get("w_coll")[:, 0]
        for frame in self._frames:
            refs[f"ee_rot:{frame}"] = get(f"ee_rot:{frame}").reshape(-1, 3, 3)
            refs[f"ee_trans:{frame}"] = get(f"ee_trans:{frame}")
            refs[f"w_ee:{frame}"] = get(f"w_ee:{frame}")
        for frame in self._vel_frames:
            refs[f"ee_vel:{frame}"] = get(f"ee_vel:{frame}")
            refs[f"w_ee_vel:{frame}"] = get(f"w_ee_vel:{frame}")
        return refs

    def row_ids(self, rows: torch.Tensor) -> torch.Tensor:
        fl = self._by_key["id"]
        return rows[:, fl.offset]


class RefRing:
    """Host staging + device mirror of packed reference rows.

    append() costs one row pack; sync() ships only rows written since the
    last sync (usually one per tick) with a single `index_copy_`; horizon
    gathers happen on the device inside the tick.
    """

    def __init__(self, layout: RowLayout, dt_factor_n_seq: DTFactorsNSeq,
                 capacity: int = 4096, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.layout = layout
        self._hidx = dt_factor_n_seq.horizon_indexes()
        span = int(self._hidx[-1]) + 1
        cap = 1
        while cap < max(capacity, 4 * span):
            cap <<= 1
        self.capacity = cap
        self._dtype = dtype
        self._host = np.zeros((cap, layout.width), _NP_DTYPE[dtype])
        self._device = torch.zeros((cap, layout.width), dtype=dtype,
                                   device=resolve_device(device))
        self._read = 0
        self._write = 0
        self._synced = 0  # rows [0, synced) are on device

    def __len__(self):
        return self._write - self._read

    @property
    def horizon_indexes(self) -> np.ndarray:
        return self._hidx

    @property
    def horizon_span(self) -> int:
        return int(self._hidx[-1]) + 1

    def append(self, wp: WeightedTrajectoryPoint):
        if self._write - self._read >= self.capacity:
            raise OverflowError("reference ring full")
        self.layout.pack_point(wp, out=self._host[self._write
                                                  & (self.capacity - 1)])
        self._write += 1

    def extend(self, wps):
        for wp in wps:
            self.append(wp)

    def clear_past(self):
        if self._write > self._read:
            self._read += 1

    def clear(self):
        """Drop everything. Device rows are rewritten before they can be
        gathered again (synced resets with write)."""
        self._read = self._write = self._synced = 0

    def pop_newest(self):
        """Drop the most recent row (mirror of `TrajectoryBuffer.pop(-1)`)."""
        if self._write == self._read:
            raise IndexError("pop from empty ring")
        self._write -= 1
        self._synced = min(self._synced, self._write)

    def set_row(self, index: int, wp: WeightedTrajectoryPoint):
        """Overwrite row at buffer-relative ``index``; marks the suffix dirty
        so the next sync() re-ships it (sync ships a contiguous range)."""
        counter = self._read + index
        if not self._read <= counter < self._write:
            raise IndexError(index)
        self.layout.pack_point(wp, out=self._host[counter
                                                  & (self.capacity - 1)])
        self._synced = min(self._synced, counter)

    def host_horizon_rows(self) -> np.ndarray:
        """Host copy of the current horizon rows [T+1, width]."""
        slots = (self._read + self._hidx) & (self.capacity - 1)
        return self._host[slots]

    def sync(self) -> torch.Tensor:
        """Ship rows written since the last sync; returns the device ring."""
        n_new = self._write - self._synced
        if n_new > 0:
            slots = np.arange(self._synced, self._write) & (self.capacity - 1)
            dev = self._device.device
            self._device.index_copy_(
                0, torch.as_tensor(slots, device=dev),
                torch.as_tensor(self._host[slots], device=dev))
            self._synced = self._write
        return self._device

    def device_state(self) -> Tuple[torch.Tensor, int]:
        """(device ring, read slot) for the horizon gather."""
        return self.sync(), self._read & (self.capacity - 1)

    def gather_spec(self):
        """(horizon offsets, capacity mask)."""
        return (np.asarray(self._hidx, np.int64), self.capacity - 1)


def gather_horizon_rows(ring_arr: torch.Tensor, read_slot, hidx: torch.Tensor,
                        cap_mask: int) -> torch.Tensor:
    """Device-side horizon gather: rows at (read + offsets) mod capacity."""
    slots = (read_slot + hidx) & cap_mask
    return ring_arr.index_select(0, slots)


class PackedTrajectoryBuffer(TrajectoryBuffer):
    """TrajectoryBuffer that mirrors every mutation into a `RefRing`.

    The Python-side buffer keeps serving the warm-start / bookkeeping path;
    the ring carries the SAME points as packed numeric rows so the per-tick
    reference update is one `index_copy_` + an on-device gather. Both heads
    advance together, so the refs the solver sees cannot diverge from the
    points the warm start saw.
    """

    def __init__(self, dt_factor_n_seq: DTFactorsNSeq, layout: RowLayout,
                 min_capacity: int = 4096, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = DEFAULT_DEVICE):
        device = resolve_device(device)
        super().__init__(dt_factor_n_seq, min_capacity)
        self.ring = RefRing(layout, self.dt_factor_n_seq,
                            capacity=self._cap, dtype=dtype, device=device)
        assert self.ring.capacity == self._cap

    def append(self, item: WeightedTrajectoryPoint):
        super().append(item)
        self.ring.append(item)

    def clear(self):
        super().clear()
        self.ring.clear()

    def clear_past(self):
        super().clear_past()
        self.ring.clear_past()

    def pop(self, index: int = -1):
        if index in (0,):
            return super().pop(0)  # routes through clear_past (mirrored)
        item = super().pop(index)  # only end pops are legal
        self.ring.pop_newest()
        return item

    def __setitem__(self, index: int, value: WeightedTrajectoryPoint):
        super().__setitem__(index, value)
        n = len(self)
        self.ring.set_row(index if index >= 0 else index + n, value)
