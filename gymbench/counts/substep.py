"""Operations and bytes of the control step (K1 on the plane, K5 on
general terrain: `decimation` substeps and the epilogue in one launch),
counted from the loop trip counts of booster_gym_torch/csrc/substep.cu as
they stood when the benchmark was written: a multiply-add is 2 operations;
sin, cos, sqrt, rsqrt and a division 1 each.  Bytes: each input read once
and each output written once per env."""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Robot:
    """The shapes the counts depend on."""
    nb: int                  # bodies
    nd: int                  # dofs
    npt: int                 # contact points
    ns: int                  # collision shapes
    nf: int                  # feet
    ne: int                  # edge points per foot
    solver_iterations: int
    anc: np.ndarray          # [nb, nd] 0/1: dof j moves body b

    @property
    def nq(self):
        """Terrain queries of a control step: points, root, edge points."""
        return self.npt + 1 + self.nf * self.ne


def robot(model, num_feet, num_edges, solver_iterations):
    """Robot from a RobotModel (reference/model/urdf.py)."""
    nb, nd = model.num_bodies, model.num_dofs
    anc = np.zeros((nb, nd), np.float32)
    for b in range(1, nb):
        a = b
        while a > 0:
            anc[b, a - 1] = 1.0
            a = int(model.parent[a])
    return Robot(nb, nd, model.num_points, len(model.shape_body), num_feet, num_edges,
                 solver_iterations, anc)


def substep_ops(r, plane=True):
    """f32 operations of one substep for one env."""
    nb, nd, npt = r.nb, r.nd, r.npt
    nv = 6 + nd
    n_anc = int(r.anc.sum())
    ops = 0
    ops += 30 + (nb - 1) * (45 + 15 + 3 + 45 + 2 + 36 + 45 + 15 + 3 + 9)  # FK
    ops += nb * (15 + 3 + 45 + 30 + 5 + 24 + 3)                         # inertias
    ops += (nb - 1) * 10                                                # composite
    ops += nd * 48 + int(np.tril(r.anc[1:, :]).sum()) * 11 + nv         # mass matrix
    ops += sum(2 * i + 1 + (nv - i - 1) * (2 * i + 1) for i in range(nv))  # Cholesky
    ops += sum(2 * (j - i - 1) + 3 for i in range(nv) for j in range(i + 1, nv))  # L^-1
    ops += sum(2 * (nv - j) for i in range(nv) for j in range(i, nv))   # G
    minv = 2 * nv * nv
    ops += (nb - 1) * (12 + 12 + 18 + 6) + nb * (2 * 45 + 27 + 6)       # RNEA
    ops += (nb - 1) * 6 + 6 + 2 * nd * 5 + minv + 2 * nv                # C, rhs, u_free
    ops += n_anc * 6 * nv * 2 + 21 * 2 * n_anc                          # Lambda_b
    ops += npt * (15 + 3 + 3 + 1)                                       # points
    ops += (nb - 1) * 12                                                # free body vel.
    ops += npt * (9 * 4 + 9 * 4 + 9 * 4 + 2 + 9 * 3 + 3 + 12 + 1 + 9 + 12 + 7 + 6)
    wrench = npt * (9 + 6) + (nb - 1) * 6 + nd * 11 + minv
    sweep = wrench + nv + (nb - 1) * 12 + npt * (9 + 6 + 3 * 6 + 3 + 7 + 2 + 3)
    ops += r.solver_iterations * sweep + wrench + nv
    ops += 9 + 12 + 11 + 28 + 9 + nd * 6 + nb * 3                      # integrate
    if not plane:
        # depth from h; the approach speed along n; per sweep the target
        # along n, l . n, the tangential vector and its norm, the
        # recombination about n
        ops += npt * (1 + 13) + r.solver_iterations * npt * (3 + 5 + 6 + 2 + 7)
    return ops


def epilogue_ops(r, sampled):
    """The epilogue's operations for one env: 6 per edge coordinate; with
    the terrain sampled, ~50 per query."""
    return 18 * r.nf * r.ne + (50 * r.nq if sampled else 0)


def control_bytes(r, plane, sampled):
    """Bytes of one control step per env: the state read and written,
    dyn, targets, latched targets, gains and joint friction read, the
    latched targets and torque sum written, the delay (int64) and the push
    read, the last substep's forces and feet written, the edge points
    written; K5 also reads h and n and writes the points' xy, and with the
    terrain sampled writes each query's height and normal.  The field is
    shared by the batch: field_bytes adds it once a launch."""
    nstate, ndyn = 13 + 2 * r.nd, 10 * r.nb + 2 * r.ns
    reads = nstate + ndyn + 5 * r.nd + 2 + 6
    writes = nstate + 2 * r.nd + 3 * r.nb + 12 * r.nf + 3 * r.nf * r.ne
    if not plane:
        reads, writes = reads + 4 * r.npt, writes + 2 * r.npt
        if sampled:
            writes += 4 * r.nq
    return 4 * (reads + writes)


def control_step(r, envs, plane, sampled, field_cells=0, decimation=10):
    """(bytes, operations) of one control-step launch over `envs` envs;
    `field_cells` the height field's cells when the launch samples it."""
    nbytes = control_bytes(r, plane, sampled) * envs + 4 * field_cells
    nops = (decimation * substep_ops(r, plane) + epilogue_ops(r, sampled)) * envs
    return nbytes, nops
