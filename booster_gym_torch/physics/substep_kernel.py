"""K1 and K5: the substep as a hand-written CUDA kernel, on the plane (K1)
and on general terrain (K5), one substep per launch or a whole control step
(the env's decimation loop) per launch.

csrc/substep.cu replaces the JAX package's Pallas kernel
(physics/pallas_engine.py, make_substep_pallas): its -DPLANE=1 build the
plane=True specialization, its -DPLANE=0 build the general form that takes
a terrain height and a unit normal per contact point.  This module wraps
both; kernel_build.py builds them with nvcc into shared libraries with a
plain C interface and loads them with ctypes.  Layout at the kernel: the
state, dyn and terrain tensors are component-major [comp, B] f32:

    state  [13 + 2 nd, B]  root_pos(3) root_quat(4) root_lin_vel(3)
                           root_ang_vel(3) q(nd) qd(nd)
    dyn    [10 nb + 2 ns, B]  mass(nb) com(3 nb) inertia(6 nb: xx yy zz xy
                           xz yz) shape_friction(ns) shape_restitution(ns)
    tau    [nd, B], ext [6, B] (force, torque)
    out    state, forces [3 nb, B], feet [12 nf, B] (pos(3), R(9) per foot)
    K5 only: in h [npt, B], n [3 npt, B] (row 3 p + k); out ptxy [2 npt, B]
    (row 2 p + k), the points' world xy from the start-of-substep FK

control_step takes the per-dof inputs batch-leading, as the env holds them:
targets, last targets, kp, kd, friction [B, nd], the delay [B] int64, the
torque limits [nd], the push [B, 6] (force, torque; substep 0 only); K5's
ph [npt, B] and pn [3 npt, B] may be strided views (the env passes the
[B, npt] columns of the last step's heights in place).  Its epilogue
computes what the env reads after the physics, from what the kernel holds
at its end: the foot edge points in the world frame [B, 3, nf ne]
(coordinate i of foot f's edge point k at [:, i, f ne + k]) and, on K5
given the height field, the terrain under the step's NQ = npt + 1 + nf ne
queries (the contact points, the root, the edge points): heights [B, NQ]
and normals [B, NQ, 3], the standalone sampler's layout, K6 + K7 folded
into the launch.

Each build's launch shape follows its robot: csrc/substep.cu picks the
envs per block and the blocks per SM that shared memory holds from the
size of its env working set (8 envs a block and 4 blocks an SM at the T1
widths; 7 or 8 and 2 for the 23-DoF serial robot's ~13 KB working sets),
and info() reports them.

The wrappers run their plain versions (physics/engine.py; the decimation
loop of control_step_plain) only for tensors on the CPU; for CUDA tensors
they launch the kernel or raise.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from booster_gym_torch import kernel_build
from booster_gym_torch.physics import engine
from booster_gym_torch.physics.types import SimState
from booster_gym_torch.terrain.sample_kernel import TerrainSampler

SOURCE = "substep.cu"
CSRC = kernel_build.source_path(SOURCE)


def tree_tables(model):
    """The kernel's walk orders: the bodies sorted by tree depth (then
    index), the start of each depth level in that order (padded with nb to
    nb + 1 entries), the contact points grouped by body in index order as
    CSR starts [nb + 1] and point list [npt], and each point's slot in that
    list [npt]."""
    parent = np.asarray(model.parent)
    nb = len(parent)
    depth = np.zeros(nb, np.int64)
    for b in range(1, nb):
        if not 0 <= parent[b] < b:
            raise ValueError("the kernel needs every body's parent before it")
        depth[b] = depth[parent[b]] + 1
    order = np.lexsort((np.arange(nb), depth))
    lstart = np.full(nb + 1, nb, np.int64)
    lstart[:depth.max() + 1] = np.searchsorted(depth[order], np.arange(depth.max() + 1))
    point_body = np.asarray(model.point_body)
    plist = np.argsort(point_body, kind="stable")
    pstart = np.searchsorted(point_body[plist], np.arange(nb + 1))
    return order, lstart, pstart, plist, np.argsort(plist)


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
        *(np.asarray(t, np.float32) for t in tree_tables(model)),
        np.asarray([cfg.dt, *cfg.gravity, cfg.solver_iterations, cfg.contact_margin,
                    cfg.baumgarte, cfg.max_pushout_vel, cfg.contact_slop,
                    cfg.bounce_threshold, cfg.relaxation, cfg.terrain_friction,
                    cfg.terrain_restitution, cfg.mass_matrix_reg], np.float32),
    ]
    return np.concatenate(parts)


def kernel_sizes(model, feet_indices, plane=True, num_edges=0):
    """The -D sizes of a build: the robot's, the foot edge points per foot
    and the terrain form.  The source picks the launch shape from them
    (csrc/substep.cu: EPB and MINB; info() reports both)."""
    return dict(NB=model.num_bodies, ND=model.num_dofs, NPT=model.num_points,
                NS=len(model.shape_body), NF=len(feet_indices), NE=int(num_edges),
                PLANE=int(plane))


def feet_edge_world(feet_pos, feet_R, edge_pos):
    """Foot edge points in the world frame as (x, y, z), each [B, nf, ne]:
    p + R e for each offset e of edge_pos (a list of [x, y, z]), every
    coordinate ((p_i + R_i0 e_0) + R_i1 e_1) + R_i2 e_2 as separate tensor
    ops, the order the control step's epilogue rounds in."""
    px, py, pz = feet_pos.unbind(-1)
    xs, ys, zs = [], [], []
    for lx, ly, lz in edge_pos:
        xs.append(px + feet_R[..., 0, 0] * lx + feet_R[..., 0, 1] * ly + feet_R[..., 0, 2] * lz)
        ys.append(py + feet_R[..., 1, 0] * lx + feet_R[..., 1, 1] * ly + feet_R[..., 1, 2] * lz)
        zs.append(pz + feet_R[..., 2, 0] * lx + feet_R[..., 2, 1] * ly + feet_R[..., 2, 2] * lz)
    return torch.stack(xs, -1), torch.stack(ys, -1), torch.stack(zs, -1)


class ControlStep(NamedTuple):
    """control_step's outputs.  state [nstate, B]; last (the latched
    targets) and tsum (the torque sum over the substeps) [B, nd]; the last
    substep's forces [3 nb, B] and feet [12 nf, B]; K5 only, the contact
    points' xy [2 npt, B]; the foot edge points [B, 3, nf ne] (None without
    edge offsets); K5 given the field, heights [B, NQ] and normals
    [B, NQ, 3] of the queries (points, root, edges), else None."""
    state: torch.Tensor
    last: torch.Tensor
    tsum: torch.Tensor
    forces: torch.Tensor
    feet: torch.Tensor
    ptxy: Optional[torch.Tensor]
    edges: Optional[torch.Tensor]
    heights: Optional[torch.Tensor]
    normals: Optional[torch.Tensor]


class SubstepKernel:
    """K1 (plane=True) or K5 (plane=False) wrapper with the substep
    signature of physics/engine.py, the packed (component-major) substep
    packed_call, and control_step, the env's whole decimation loop in one
    launch.

    `launches` counts kernel launches of either entry point; it moves only
    where the CUDA kernel is launched.  `fused_sampler_launches` counts the
    control-step launches whose epilogue sampled the terrain (K6 + K7
    folded in).

    feet_edge_pos: the foot edge offsets [ne, 3] in each foot's frame
    (none: no edge points).  terrain: K5's heightfield Terrain, whose
    queries control_step's epilogue answers; `sampler` is then the
    standalone TerrainSampler of the same NQ queries, whose plain version
    control_step_plain runs."""

    def __init__(self, model, cfg, feet_indices, device, plane=True, feet_edge_pos=None,
                 terrain=None):
        self.plane = bool(plane)
        self.feet_indices = [int(i) for i in feet_indices]
        self.nb, self.nd, self.npt = model.num_bodies, model.num_dofs, model.num_points
        self.ns, self.nf = len(model.shape_body), len(self.feet_indices)
        self.nstate = 13 + 2 * self.nd
        self.ndyn = 10 * self.nb + 2 * self.ns
        self.device = torch.device(device)
        edge = np.zeros((0, 3), np.float32) if feet_edge_pos is None else np.asarray(
            feet_edge_pos, np.float32).reshape(-1, 3)
        self.ne = edge.shape[0]
        self.edge_list = edge.tolist()
        self.edge_pos = torch.as_tensor(edge, device=self.device)
        self.nq = self.npt + 1 + self.nf * self.ne
        self.sampler = None
        if terrain is not None:
            if self.plane:
                raise ValueError("the plane kernel samples no terrain")
            self.sampler = TerrainSampler(terrain, self.nq, self.device)
        self.sizes = kernel_sizes(model, self.feet_indices, self.plane, self.ne)
        self.plain = engine.make_substep(model, cfg, self.feet_indices, device)
        self.tables = torch.as_tensor(model_tables(model, cfg, self.feet_indices),
                                      device=self.device)
        self.launches = 0
        self.fused_sampler_launches = 0
        self._launch = self._control = None

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
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if self.plane:
            names = ("bg_substep", "bg_control")
            control = [ptr] * 18 + [i32, i32, ptr]
        else:
            names = ("bg_substep_terrain", "bg_control_terrain")
            control = [ptr] * 24 + [i32] * 6 + [f32, f32, i32, i32, ptr]
        lib = kernel_build.load(path, {
            names[0]: [ptr] * (8 if self.plane else 11) + [i32, ptr],
            names[1]: control,
            "bg_substep_info": [ptr]})
        self._launch, self._control = getattr(lib, names[0]), getattr(lib, names[1])
        self._info = lib.bg_substep_info
        return report

    def info(self):
        """The launch shape on the current card: shared memory per block
        (bytes), envs per block, the resident blocks per SM asked of ptxas,
        and those of the substep and the control-step kernel
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
        if self._launch is None:
            self.build()
        out = (ctypes.c_int * 5)()
        err = self._info(ctypes.cast(out, ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"substep kernel occupancy query failed: cudaError {err}")
        return dict(smem_bytes=out[0], envs_per_block=out[1], min_blocks_per_sm=out[4],
                    blocks_per_sm_substep=out[2], blocks_per_sm_control=out[3])

    def _check(self, name, t, shape, dtype=torch.float32, strided=False):
        if t.device != self.tables.device:
            raise ValueError(f"{name} is on {t.device}, the kernel's tables on "
                             f"{self.tables.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not (strided or t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous")

    def _check_terrain(self, ph, pn, B, strided=False):
        """ph [npt, B] and pn [3 npt, B] for K5 only, contiguous unless
        `strided` (control_step reads them at their strides)."""
        if (ph is None) != self.plane or (pn is None) != self.plane:
            raise ValueError("point heights and normals go to the general-terrain kernel "
                             f"only (plane={self.plane})")
        if not self.plane and ph.device.type == "cuda":
            for name, t, rows in (("point heights", ph, self.npt),
                                  ("point normals", pn, 3 * self.npt)):
                self._check(name, t, (rows, B), strided=strided)

    def _packed_plain(self, psim, pdyn, ptau, pext, ph, pn):
        """The plain version of packed_call, on any device."""
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

    def packed_call(self, psim, pdyn, ptau, pext, ph=None, pn=None):
        """Packed substep: [comp, B] in, (state', forces, feet, ptxy) out.
        K1 takes no ph/pn and returns ptxy None; K5 needs both."""
        B = psim.shape[1]
        self._check_terrain(ph, pn, B)
        if psim.device.type == "cpu":
            return self._packed_plain(psim, pdyn, ptau, pext, ph, pn)
        if psim.device.type != "cuda":
            raise ValueError(f"no substep for device {psim.device}")
        for name, t, rows in (("state", psim, self.nstate), ("dyn", pdyn, self.ndyn),
                              ("tau", ptau, self.nd), ("ext", pext, 6)):
            self._check(name, t, (rows, B))
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

    def _check_field(self, hf):
        if hf is None:
            return
        if self.sampler is None:
            raise ValueError("control_step samples a height field only on a general-terrain "
                             "kernel built with its terrain")
        if hf.dim() != 2:
            raise ValueError(f"the height field must be [R, C], got {tuple(hf.shape)}")
        if hf.device.type == "cuda":
            self._check("height field", hf, tuple(hf.shape))

    def _epilogue_plain(self, psim, pfeet, pptxy, hf):
        """The epilogue's outputs from the plain loop's: the edge points by
        feet_edge_world, the queries' terrain by the sampler's plain
        version, in the kernel's layouts."""
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
            heights, normals = self.sampler.plain(hf, root_xy, torch.cat(queries, dim=1))
        return edges, heights, normals

    def control_step_plain(self, psim, pdyn, targets, last, delay, kp, kd, fric, lim, ext,
                           ph=None, pn=None, hf=None, decimation=10):
        """The decimation loop around the plain substep, in the packed
        layout: per substep i the delay latch (last = targets where delay
        == i), PD kp (last - q) - kd qd, Coulomb joint friction
        min(|pd|, fric) sign(pd), the clip to +-lim, the push on substep 0
        only, then the substep; then the epilogue's outputs
        (_epilogue_plain).  Returns control_step's outputs."""
        nd = self.nd
        if ph is not None:   # contiguous: the plain substep's CPU rounding follows the layout
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
            psim, pforces, pfeet, pptxy = self._packed_plain(
                psim, pdyn, p_tau, p_ext if i == 0 else p_ext0, ph, pn)
            p_tsum = p_tsum + p_tau
        return ControlStep(psim, p_last.T, p_tsum.T, pforces, pfeet, pptxy,
                           *self._epilogue_plain(psim, pfeet, pptxy, hf))

    def control_step(self, psim, pdyn, targets, last, delay, kp, kd, fric, lim, ext,
                     ph=None, pn=None, hf=None, decimation=10):
        """One control step, `decimation` substeps, in one launch.

        psim [nstate, B] and pdyn [ndyn, B] as packed_call's; targets, last
        (the latched targets), kp, kd, fric [B, nd]; delay [B] int64 (the
        substep from which the new targets act); lim [nd]; ext [B, 6] (push
        force and torque, substep 0 only); K5 also ph [npt, B], pn [3 npt,
        B] (views at any strides), the terrain under the points for the
        whole control step, and optionally hf [R, C], the height field whose
        terrain the epilogue samples under the step's queries.  Returns a
        ControlStep."""
        B = psim.shape[1]
        self._check_terrain(ph, pn, B, strided=True)
        self._check_field(hf)
        args = (psim, pdyn, targets, last, delay, kp, kd, fric, lim, ext, ph, pn, hf)
        if psim.device.type == "cpu":
            return self.control_step_plain(*args, decimation=decimation)
        if psim.device.type != "cuda":
            raise ValueError(f"no control step for device {psim.device}")
        nd = self.nd
        for name, t, shape, dtype in (
                ("state", psim, (self.nstate, B), torch.float32),
                ("dyn", pdyn, (self.ndyn, B), torch.float32),
                ("targets", targets, (B, nd), torch.float32),
                ("last targets", last, (B, nd), torch.float32),
                ("delay", delay, (B,), torch.int64),
                ("kp", kp, (B, nd), torch.float32), ("kd", kd, (B, nd), torch.float32),
                ("friction", fric, (B, nd), torch.float32),
                ("torque limits", lim, (nd,), torch.float32),
                ("ext", ext, (B, 6), torch.float32)):
            self._check(name, t, shape, dtype)
        if self._control is None:
            self.build()
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=psim.device)
        s_out, last_out, tsum = torch.empty_like(psim), new(B, nd), new(B, nd)
        f_out, feet = new(3 * self.nb, B), new(12 * self.nf, B)
        edges = new(B, 3, self.nf * self.ne) if self.ne else None
        ptr = lambda *ts: [None if t is None else t.data_ptr() for t in ts]
        stream = torch.cuda.current_stream(psim.device).cuda_stream
        inputs = ptr(psim, pdyn, targets, last, delay, kp, kd, fric, lim, ext)
        outputs = ptr(s_out, last_out, tsum, f_out, feet)
        epos = self.edge_pos if self.ne else None
        ptxy = heights = normals = None
        if self.plane:
            err = self._control(*inputs, *ptr(self.tables, epos), *outputs, *ptr(edges), B,
                                decimation, stream)
        else:
            ptxy = new(2 * self.npt, B)
            R = C = 0
            bp = hs = 0.0
            if hf is not None:
                heights, normals = new(B, self.nq), new(B, self.nq, 3)
                R, C = hf.shape
                bp, hs = self.sampler.bp, self.sampler.hs
            err = self._control(*inputs, *ptr(ph, pn, self.tables, epos, hf), *outputs,
                                *ptr(ptxy, edges, heights, normals), *ph.stride(), *pn.stride(),
                                R, C, bp, hs, B, decimation, stream)
        if err != 0:
            raise RuntimeError(f"control-step kernel launch failed: cudaError {err}")
        self.launches += 1
        if hf is not None:
            self.fused_sampler_launches += 1
        return ControlStep(s_out, last_out, tsum, f_out, feet, ptxy, edges, heights, normals)

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
