"""K1 and K5: the substep as a hand-written CUDA kernel, on the plane (K1)
and on general terrain (K5).

csrc/substep.cu replaces the JAX package's Pallas kernel
(physics/pallas_engine.py, make_substep_pallas): its -DPLANE=1 build the
plane=True specialization, its -DPLANE=0 build the general form that takes
a terrain height and a unit normal per contact point.  This module wraps
both; kernel_build.py builds them with nvcc into shared libraries with a
plain C interface and loads them with ctypes.  Layout at the kernel: every
tensor is component-major [comp, B] f32:

    state  [13 + 2 nd, B]  root_pos(3) root_quat(4) root_lin_vel(3)
                           root_ang_vel(3) q(nd) qd(nd)
    dyn    [10 nb + 2 ns, B]  mass(nb) com(3 nb) inertia(6 nb: xx yy zz xy
                           xz yz) shape_friction(ns) shape_restitution(ns)
    tau    [nd, B], ext [6, B] (force, torque)
    out    state, forces [3 nb, B], feet [12 nf, B] (pos(3), R(9) per foot)
    K5 only: in h [npt, B], n [3 npt, B] (row 3 p + k); out ptxy [2 npt, B]
    (row 2 p + k), the points' world xy from the start-of-substep FK

The wrapper runs the plain version (physics/engine.py) only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

import ctypes

import numpy as np
import torch

from booster_gym_torch import kernel_build
from booster_gym_torch.physics import engine
from booster_gym_torch.physics.types import SimState

SOURCE = "substep.cu"
CSRC = kernel_build.source_path(SOURCE)


def model_tables(model, cfg, feet_indices):
    """The robot and solver constants as the kernel's f32 table (layout:
    the OFF_* macros of csrc/substep.cu)."""
    parts = [
        np.asarray(model.parent, np.float32),
        np.asarray(model.joint_pos, np.float32).reshape(-1),
        np.asarray(model.joint_rot, np.float32).reshape(-1),
        np.asarray(model.joint_axis, np.float32).reshape(-1),
        engine.ancestor_dof_mask(model).reshape(-1),
        np.asarray(model.dof_lower, np.float32),
        np.asarray(model.dof_upper, np.float32),
        np.asarray(model.point_body, np.float32),
        np.asarray(model.point_shape, np.float32),
        np.asarray(model.point_pos, np.float32).reshape(-1),
        np.asarray(model.point_radius, np.float32),
        np.asarray(feet_indices, np.float32),
        np.asarray([cfg.dt, *cfg.gravity, cfg.solver_iterations, cfg.contact_margin,
                    cfg.baumgarte, cfg.max_pushout_vel, cfg.contact_slop,
                    cfg.bounce_threshold, cfg.relaxation, cfg.terrain_friction,
                    cfg.terrain_restitution, cfg.mass_matrix_reg], np.float32),
    ]
    return np.concatenate(parts)


def kernel_sizes(model, feet_indices, plane=True):
    return dict(NB=model.num_bodies, ND=model.num_dofs, NPT=model.num_points,
                NS=len(model.shape_body), NF=len(feet_indices), PLANE=int(plane))


class SubstepKernel:
    """K1 (plane=True) or K5 (plane=False) wrapper with the substep
    signature of physics/engine.py plus the packed (component-major) entry
    points the env's decimation loop uses.

    `launches` counts kernel launches; it moves only where the CUDA kernel
    is launched."""

    def __init__(self, model, cfg, feet_indices, device, plane=True):
        self.plane = bool(plane)
        self.feet_indices = [int(i) for i in feet_indices]
        self.nb, self.nd, self.npt = model.num_bodies, model.num_dofs, model.num_points
        self.ns, self.nf = len(model.shape_body), len(self.feet_indices)
        self.nstate = 13 + 2 * self.nd
        self.ndyn = 10 * self.nb + 2 * self.ns
        self.sizes = kernel_sizes(model, self.feet_indices, self.plane)
        self.device = torch.device(device)
        self.plain = engine.make_substep(model, cfg, self.feet_indices, device)
        self.tables = torch.as_tensor(model_tables(model, cfg, self.feet_indices),
                                      device=self.device)
        self.launches = 0
        self._launch = None

    # -- layout ---------------------------------------------------------
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
        """DynParams -> [10 nb + 2 ns, B]; invariant across substeps, so the
        env packs it once per control step."""
        B = dyn.body_mass.shape[0]
        I = dyn.body_inertia
        in6 = torch.stack([I[..., 0, 0], I[..., 1, 1], I[..., 2, 2],
                           I[..., 0, 1], I[..., 0, 2], I[..., 1, 2]], dim=-1)
        return torch.cat([dyn.body_mass, dyn.body_com.reshape(B, -1), in6.reshape(B, -1),
                          dyn.shape_friction, dyn.shape_restitution], dim=-1).T.contiguous()

    def unpack_dyn(self, pd):
        from booster_gym_torch.physics.types import DynParams

        x = pd.T
        nb, ns, B = self.nb, self.ns, pd.shape[1]
        in6 = x[:, 4 * nb:10 * nb].reshape(B, nb, 6)
        xx, yy, zz, xy, xz, yz = in6.unbind(-1)
        inertia = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(B, nb, 3, 3)
        return DynParams(body_mass=x[:, :nb], body_com=x[:, nb:4 * nb].reshape(B, nb, 3),
                         body_inertia=inertia, shape_friction=x[:, 10 * nb:10 * nb + ns],
                         shape_restitution=x[:, 10 * nb + ns:10 * nb + 2 * ns])

    # -- kernel ---------------------------------------------------------
    def build(self):
        """Build (if needed) and load the library; returns nvcc's report."""
        path, report = kernel_build.build(SOURCE, self.sizes)
        name, pointers = ("bg_substep", 8) if self.plane else ("bg_substep_terrain", 11)
        lib = kernel_build.load(path, {
            name: [ctypes.c_void_p] * pointers + [ctypes.c_int, ctypes.c_void_p]})
        self._launch = getattr(lib, name)
        return report

    def _check(self, name, t, rows, B):
        if t.device != self.tables.device:
            raise ValueError(f"{name} is on {t.device}, the kernel's tables on "
                             f"{self.tables.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (rows, B):
            raise ValueError(f"{name} must have shape {(rows, B)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def packed_call(self, psim, pdyn, ptau, pext, ph=None, pn=None):
        """Packed substep: [comp, B] in, (state', forces, feet, ptxy) out.
        K1 takes no ph/pn and returns ptxy None; K5 needs both."""
        if (ph is None) != self.plane or (pn is None) != self.plane:
            raise ValueError("point heights and normals go to the general-terrain kernel "
                             f"only (plane={self.plane})")
        B = psim.shape[1]
        if psim.device.type == "cpu":
            args = (self.unpack_sim(psim), self.unpack_dyn(pdyn), ptau.T, pext[:3].T, pext[3:].T)
            if self.plane:
                out, ptxy = self.plain(*args), None
            else:
                out = self.plain.terrain_form(*args, ph.T, pn.T.reshape(B, self.npt, 3))
                ptxy = out[4].reshape(B, -1).T.contiguous()
            return (self.pack_sim(out[0]), out[1].reshape(B, -1).T.contiguous(),
                    torch.cat([out[2], out[3].reshape(B, self.nf, 9)], dim=-1)
                    .reshape(B, -1).T.contiguous(), ptxy)
        if psim.device.type != "cuda":
            raise ValueError(f"no substep for device {psim.device}")
        checks = [("state", psim, self.nstate), ("dyn", pdyn, self.ndyn),
                  ("tau", ptau, self.nd), ("ext", pext, 6)]
        if not self.plane:
            checks += [("point heights", ph, self.npt), ("point normals", pn, 3 * self.npt)]
        for name, t, rows in checks:
            self._check(name, t, rows, B)
        if self._launch is None:
            self.build()
        new = lambda rows: torch.empty((rows, B), dtype=torch.float32, device=psim.device)
        s_out, f_out, feet = torch.empty_like(psim), new(3 * self.nb), new(12 * self.nf)
        ptr = lambda *ts: [t.data_ptr() for t in ts]
        stream = torch.cuda.current_stream(psim.device).cuda_stream
        if self.plane:
            ptxy = None
            err = self._launch(*ptr(psim, pdyn, ptau, pext, self.tables, s_out, f_out, feet),
                               B, stream)
        else:
            ptxy = new(2 * self.npt)
            err = self._launch(*ptr(psim, pdyn, ptau, pext, ph, pn, self.tables, s_out, f_out,
                                    feet, ptxy), B, stream)
        if err != 0:
            raise RuntimeError(f"substep kernel launch failed: cudaError {err}")
        self.launches += 1
        return s_out, f_out, feet, ptxy

    def _unpack_out(self, ps, pf, pfeet, B):
        feet = pfeet.T.reshape(B, self.nf, 12)
        return (self.unpack_sim(ps), pf.T.reshape(B, self.nb, 3), feet[..., 0:3],
                feet[..., 3:12].reshape(B, self.nf, 3, 3))

    def terrain_form(self, state, dyn, tau, ext_force, ext_torque, point_heights,
                     point_normals):
        """General form: terrain heights [B, npt] and unit normals
        [B, npt, 3] per contact point in; the substep's outputs and the
        points' world xy [B, npt, 2] out.  K5 only."""
        if self.plane:
            raise ValueError("terrain_form is unavailable on a plane-specialized kernel; "
                             "build SubstepKernel(..., plane=False) for trimesh")
        B = tau.shape[0]
        ps, pf, pfeet, ptxy = self.packed_call(
            self.pack_sim(state), self.pack_dyn(dyn), tau.T.contiguous(),
            torch.cat([ext_force, ext_torque], dim=-1).T.contiguous(),
            point_heights.T.contiguous(), point_normals.reshape(B, -1).T.contiguous())
        return (*self._unpack_out(ps, pf, pfeet, B), ptxy.T.reshape(B, self.npt, 2))

    def step(self, state, dyn, tau, ext_force, ext_torque):
        """Same signature and results as physics/engine.py's plane substep
        (K5: on h = 0, n = +z)."""
        B = tau.shape[0]
        if not self.plane:
            h = torch.zeros((B, self.npt), dtype=torch.float32, device=tau.device)
            n = torch.zeros((B, self.npt, 3), dtype=torch.float32, device=tau.device)
            n[..., 2] = 1.0
            return self.terrain_form(state, dyn, tau, ext_force, ext_torque, h, n)[:4]
        ps, pf, pfeet, _ = self.packed_call(
            self.pack_sim(state), self.pack_dyn(dyn), tau.T.contiguous(),
            torch.cat([ext_force, ext_torque], dim=-1).T.contiguous())
        return self._unpack_out(ps, pf, pfeet, B)
