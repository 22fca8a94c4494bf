"""K1: the plane-terrain substep as a hand-written CUDA kernel.

csrc/substep.cu replaces the JAX package's Pallas kernel
(physics/pallas_engine.py, make_substep_pallas(plane=True)).  This module
wraps it; kernel_build.py builds it with nvcc into a shared library with a
plain C interface and loads it with ctypes.  Layout at the kernel: every tensor is
component-major [comp, B] f32:

    state  [13 + 2 nd, B]  root_pos(3) root_quat(4) root_lin_vel(3)
                           root_ang_vel(3) q(nd) qd(nd)
    dyn    [10 nb + 2 ns, B]  mass(nb) com(3 nb) inertia(6 nb: xx yy zz xy
                           xz yz) shape_friction(ns) shape_restitution(ns)
    tau    [nd, B], ext [6, B] (force, torque)
    out    state, forces [3 nb, B], feet [12 nf, B] (pos(3), R(9) per foot)

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


def kernel_sizes(model, feet_indices):
    return dict(NB=model.num_bodies, ND=model.num_dofs, NPT=model.num_points,
                NS=len(model.shape_body), NF=len(feet_indices))


class SubstepKernel:
    """K1 wrapper with the substep signature of physics/engine.py plus the
    packed (component-major) entry points the env's decimation loop uses.

    `launches` counts kernel launches; it moves only where the CUDA kernel
    is launched."""

    def __init__(self, model, cfg, feet_indices, device):
        self.feet_indices = [int(i) for i in feet_indices]
        self.nb, self.nd = model.num_bodies, model.num_dofs
        self.ns, self.nf = len(model.shape_body), len(self.feet_indices)
        self.nstate = 13 + 2 * self.nd
        self.ndyn = 10 * self.nb + 2 * self.ns
        self.sizes = kernel_sizes(model, self.feet_indices)
        self.device = torch.device(device)
        self.plain = engine.make_substep(model, cfg, self.feet_indices, device)
        self.tables = torch.as_tensor(model_tables(model, cfg, self.feet_indices),
                                      device=self.device)
        self.launches = 0
        self._lib = None

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
        self._lib = kernel_build.load(path, {
            "bg_substep": [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]})
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

    def packed_call(self, psim, pdyn, ptau, pext):
        """Packed substep: [comp, B] in, (state', forces, feet) out."""
        if psim.device.type == "cpu":
            out = self.plain(self.unpack_sim(psim), self.unpack_dyn(pdyn), ptau.T,
                             pext[:3].T, pext[3:].T)
            B = psim.shape[1]
            return (self.pack_sim(out[0]), out[1].reshape(B, -1).T.contiguous(),
                    torch.cat([out[2], out[3].reshape(B, self.nf, 9)], dim=-1)
                    .reshape(B, -1).T.contiguous())
        if psim.device.type != "cuda":
            raise ValueError(f"no substep for device {psim.device}")
        B = psim.shape[1]
        for name, t, rows in (("state", psim, self.nstate), ("dyn", pdyn, self.ndyn),
                              ("tau", ptau, self.nd), ("ext", pext, 6)):
            self._check(name, t, rows, B)
        if self._lib is None:
            self.build()
        s_out = torch.empty_like(psim)
        f_out = torch.empty((3 * self.nb, B), dtype=torch.float32, device=psim.device)
        feet = torch.empty((12 * self.nf, B), dtype=torch.float32, device=psim.device)
        stream = torch.cuda.current_stream(psim.device).cuda_stream
        err = self._lib.bg_substep(psim.data_ptr(), pdyn.data_ptr(), ptau.data_ptr(),
                                   pext.data_ptr(), self.tables.data_ptr(), s_out.data_ptr(),
                                   f_out.data_ptr(), feet.data_ptr(), B, stream)
        if err != 0:
            raise RuntimeError(f"substep kernel launch failed: cudaError {err}")
        self.launches += 1
        return s_out, f_out, feet

    def step(self, state, dyn, tau, ext_force, ext_torque):
        """Same signature and results as physics/engine.py's substep."""
        B = tau.shape[0]
        ps, pf, pfeet = self.packed_call(
            self.pack_sim(state), self.pack_dyn(dyn), tau.T.contiguous(),
            torch.cat([ext_force, ext_torque], dim=-1).T.contiguous())
        feet = pfeet.T.reshape(B, self.nf, 12)
        return (self.unpack_sim(ps), pf.T.reshape(B, self.nb, 3), feet[..., 0:3],
                feet[..., 3:12].reshape(B, self.nf, 3, 3))
