"""The control step and the terrain sampler in plain PyTorch: the env's
decimation loop around the plain substep (physics/engine.py), then the
epilogue's foot edge points and, on trimesh, the terrain under the step's
queries (the contact points, the root, the foot edge points).

A frozen copy of the plain versions of booster_gym_torch's
physics/substep_kernel.py (control_step_plain) and terrain/sample_kernel.py
(TerrainSampler.plain), kept beside the benchmark so that the yardstick does
not move with the program.  It builds and launches no kernel.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from gymbench.reference.physics import engine
from gymbench.reference.physics.types import DynParams, SimState

PX = 24   # patch rows and columns of the sampler


class TerrainSampler:
    """sample(hf [R, C], root_xy [B, 2], pts_xy [B, N, 2]) -> (h [B, N],
    n [B, N, 3]): the bilinear height and unit normal under each query,
    each query clamped inside the 8-aligned [24, 24] patch around its
    env's root."""

    def __init__(self, terrain, device):
        self.hs = float(terrain.horizontal_scale)
        self.bp = float(terrain.border_pixels)
        self._hs = torch.full((1,), self.hs, dtype=torch.float32, device=device)

    def __call__(self, hf, root_xy, pts_xy):
        R, C = hf.shape
        Rp = -(-R // 8) * 8
        S = max(1, max(0, C - 17) // 8 + 1)
        rx = self.bp + root_xy[..., 0] / self._hs
        ry = self.bp + root_xy[..., 1] / self._hs
        ox = torch.clamp(torch.floor(rx).long() - 7, 0, Rp - PX) // 8 * 8
        oy = torch.clamp(torch.floor(ry).long() - 7, 0, 8 * (S - 1)) // 8 * 8
        gx = self.bp + pts_xy[..., 0] / self._hs
        gy = self.bp + pts_xy[..., 1] / self._hs
        px = torch.clamp(gx - ox[:, None].float(), 0.0, PX - 1.001)
        py = torch.clamp(gy - oy[:, None].float(), 0.0, PX - 1.001)
        x1, y1 = torch.floor(px), torch.floor(py)
        fx, fy = px - x1, py - y1
        ix, iy = ox[:, None] + x1.long(), oy[:, None] + y1.long()
        r0, r1 = ix.clamp(max=R - 1), (ix + 1).clamp(max=R - 1)
        c0, c1 = iy.clamp(max=C - 1), (iy + 1).clamp(max=C - 1)
        h11, h21, h12, h22 = hf[r0, c0], hf[r1, c0], hf[r0, c1], hf[r1, c1]
        h = ((1 - fx) * (1 - fy) * h11 + fx * (1 - fy) * h21
             + (1 - fx) * fy * h12 + fx * fy * h22)
        dhdx = ((1 - fy) * (h21 - h11) + fy * (h22 - h12)) / self._hs
        dhdy = ((1 - fx) * (h12 - h11) + fx * (h22 - h21)) / self._hs
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        return h, n / torch.linalg.norm(n, dim=-1, keepdim=True)


def feet_edge_world(feet_pos, feet_R, edge_pos):
    """Foot edge points in the world frame as (x, y, z), each [B, nf, ne]."""
    px, py, pz = feet_pos.unbind(-1)
    xs, ys, zs = [], [], []
    for lx, ly, lz in edge_pos:
        xs.append(px + feet_R[..., 0, 0] * lx + feet_R[..., 0, 1] * ly + feet_R[..., 0, 2] * lz)
        ys.append(py + feet_R[..., 1, 0] * lx + feet_R[..., 1, 1] * ly + feet_R[..., 1, 2] * lz)
        zs.append(pz + feet_R[..., 2, 0] * lx + feet_R[..., 2, 1] * ly + feet_R[..., 2, 2] * lz)
    return torch.stack(xs, -1), torch.stack(ys, -1), torch.stack(zs, -1)


class ControlStep(NamedTuple):
    """The control step's outputs, in the packed layouts: state [nstate,
    B]; last (the latched targets) and tsum (the torque sum) [B, nd]; the
    last substep's forces [3 nb, B] and feet [12 nf, B]; on trimesh the
    contact points' xy [2 npt, B]; the foot edge points [B, 3, nf ne];
    on trimesh given the field, heights [B, NQ] and normals [B, NQ, 3]."""
    state: torch.Tensor
    last: torch.Tensor
    tsum: torch.Tensor
    forces: torch.Tensor
    feet: torch.Tensor
    ptxy: Optional[torch.Tensor]
    edges: Optional[torch.Tensor]
    heights: Optional[torch.Tensor]
    normals: Optional[torch.Tensor]


class PlainControl:
    """The env's control step in plain PyTorch, on the plane or (plane
    False) on the terrain under each contact point."""

    def __init__(self, model, cfg, feet_indices, device, plane=True, feet_edge_pos=None,
                 terrain=None):
        self.plane = bool(plane)
        self.feet_indices = [int(i) for i in feet_indices]
        self.nb, self.nd, self.npt = model.num_bodies, model.num_dofs, model.num_points
        self.ns, self.nf = len(model.shape_body), len(self.feet_indices)
        edge = np.zeros((0, 3), np.float32) if feet_edge_pos is None else np.asarray(
            feet_edge_pos, np.float32).reshape(-1, 3)
        self.ne = edge.shape[0]
        self.edge_list = edge.tolist()
        self.nq = self.npt + 1 + self.nf * self.ne
        self.sampler = None if terrain is None else TerrainSampler(terrain, device)
        self.plain = engine.make_substep(model, cfg, self.feet_indices, device)

    @staticmethod
    def pack_sim(state: SimState):
        return torch.cat([getattr(state, k) for k in SimState.FIELDS], dim=-1).T.contiguous()

    def unpack_sim(self, ps):
        x = ps.T
        nd = self.nd
        return SimState(root_pos=x[:, 0:3], root_quat=x[:, 3:7], root_lin_vel=x[:, 7:10],
                        root_ang_vel=x[:, 10:13], q=x[:, 13:13 + nd],
                        qd=x[:, 13 + nd:13 + 2 * nd])

    def pack_dyn(self, dyn):
        B = dyn.body_mass.shape[0]
        I = dyn.body_inertia
        in6 = torch.stack([I[..., 0, 0], I[..., 1, 1], I[..., 2, 2],
                           I[..., 0, 1], I[..., 0, 2], I[..., 1, 2]], dim=-1)
        return torch.cat([dyn.body_mass, dyn.body_com.reshape(B, -1), in6.reshape(B, -1),
                          dyn.shape_friction, dyn.shape_restitution], dim=-1).T.contiguous()

    def unpack_dyn(self, pd):
        x = pd.T
        nb, ns, B = self.nb, self.ns, pd.shape[1]
        in6 = x[:, 4 * nb:10 * nb].reshape(B, nb, 6)
        xx, yy, zz, xy, xz, yz = in6.unbind(-1)
        inertia = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(B, nb, 3, 3)
        return DynParams(body_mass=x[:, :nb], body_com=x[:, nb:4 * nb].reshape(B, nb, 3),
                         body_inertia=inertia, shape_friction=x[:, 10 * nb:10 * nb + ns],
                         shape_restitution=x[:, 10 * nb + ns:10 * nb + 2 * ns])

    def _packed(self, psim, pdyn, ptau, pext, ph, pn):
        B = psim.shape[1]
        args = (self.unpack_sim(psim), self.unpack_dyn(pdyn), ptau.T, pext[:3].T, pext[3:].T)
        if self.plane:
            out, ptxy = self.plain(*args), None
        else:
            out = self.plain.terrain_form(*args, ph.T, pn.T.reshape(B, self.npt, 3))
            ptxy = out[4].reshape(B, -1).T.contiguous()
        return (self.pack_sim(out[0]), out[1].reshape(B, -1).T.contiguous(),
                torch.cat([out[2], out[3].reshape(B, self.nf, 9)], dim=-1)
                .reshape(B, -1).T.contiguous(), ptxy)

    def _epilogue(self, psim, pfeet, pptxy, hf):
        B, nf = psim.shape[1], self.nf
        edges = heights = normals = None
        edge_xyz = None
        if self.ne:
            feet = pfeet.T.reshape(B, nf, 12)
            edge_xyz = feet_edge_world(feet[..., 0:3], feet[..., 3:12].reshape(B, nf, 3, 3),
                                       self.edge_list)
            edges = torch.stack([c.reshape(B, -1) for c in edge_xyz], dim=1)
        if hf is not None:
            root_xy = psim[0:2].T.contiguous()
            queries = [pptxy.T.reshape(B, self.npt, 2), root_xy[:, None, :]]
            if edge_xyz is not None:
                queries.append(torch.stack([edge_xyz[0].reshape(B, -1),
                                            edge_xyz[1].reshape(B, -1)], -1))
            heights, normals = self.sampler(hf, root_xy, torch.cat(queries, dim=1))
        return edges, heights, normals

    def control_step(self, psim, pdyn, targets, last, delay, kp, kd, fric, lim, ext,
                     ph=None, pn=None, hf=None, decimation=10):
        """Per substep i: the delay latch (last = targets where delay == i),
        PD kp (last - q) - kd qd, Coulomb joint friction min(|pd|, fric)
        sign(pd), the clip to +-lim, the push on substep 0 only, then the
        substep; then the epilogue's outputs."""
        nd = self.nd
        if ph is not None:
            ph, pn = ph.contiguous(), pn.contiguous()
        p_targets, p_last = targets.T, last.T
        kp, kd, fric_lim = kp.T, kd.T, fric.T
        p_ext = ext.T.contiguous()
        p_ext0 = torch.zeros_like(p_ext)
        lim = lim[:, None]
        p_tsum = torch.zeros_like(p_targets)
        for i in range(decimation):
            latch = (delay == i)[None, :]
            p_last = torch.where(latch, p_targets, p_last)
            pd = kp * (p_last - psim[13:13 + nd]) - kd * psim[13 + nd:13 + 2 * nd]
            friction = torch.minimum(torch.abs(pd), fric_lim) * torch.sign(pd)
            p_tau = torch.minimum(torch.maximum(pd - friction, -lim), lim).contiguous()
            psim, pforces, pfeet, pptxy = self._packed(
                psim, pdyn, p_tau, p_ext if i == 0 else p_ext0, ph, pn)
            p_tsum = p_tsum + p_tau
        return ControlStep(psim, p_last.T, p_tsum.T, pforces, pfeet, pptxy,
                           *self._epilogue(psim, pfeet, pptxy, hf))
