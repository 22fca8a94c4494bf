"""The fused PPO update: K2, K3 and K4 as hand-written CUDA kernels
(csrc/update.cu), replacing the Pallas kernels of
booster_gym_tpu/algo/update_kernel.py, and the rest of that module's
FusedUpdate, K8, K9 and K10, which the training iteration does not call.

  K2  gae          critic values on the T + 1 observation planes, timeout
                   bootstrap, the GAE recurrence, returns, sum(adv) and
                   sum(adv^2)                       (replaces _gae_kernel)
  K3  grads_stats  actor and critic forward, advantage normalisation, the
                   clipped-surrogate, value and bound loss gradients, the
                   backward through both MLPs into one flat f32 gradient,
                   five metric sums, and the forward's mu and logp
                                             (replaces _grads_stats_kernel)
  K4  opt_stage    entropy gradient on logstd, global-norm clip, Adam, and
                   the compute-type copy of the new parameters
                                               (replaces _opt_stage_kernel)
  K8  values       the critic on [obs || priv], any leading shape: K2's
                   critic kernel without the walk (replaces _values_kernel)
  K9  grads        K3's gradient on advantages as given, the loss means over
                   n_total rows, no metric sums; mu and values come back
                   rounded to the compute type     (replaces _grads_kernel)
  K10 policy_old_logp  K3's actor forward and log-prob on prepare()'d
                   inputs                   (replaces _policy_logp_kernel)

Each wrapper runs its plain PyTorch version (the *_plain method beside it)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  A wrapper call counts as one launch.  Every launch but K4's first
copies the staged weights into a zero-padded layer layout (k_pad, one small
device kernel), so the device kernels per call are: K2 two (the copy, then
the critic with the GAE walk fused in), K3 and K9 four (the copy, pass 1,
pass 2, the reduce), K4 one (a cooperative launch of 64 blocks that read g,
m, v and p once into registers, sum the squares per block and share the
norm through one grid barrier), K8 and K10 two.

K2 and K8 run a forward-only critic kernel (csrc/update.cu k2_critic):
clusters of 2 blocks (4 in f32) share the critic's weights out between
them, each block keeps its share in shared memory for the whole launch,
and each layer's outputs cross to the other blocks by distributed shared
memory; a block's two warp groups each take half of every tile.  K2's
cluster owns groups of 64 envs (32 in f32) over all T + 1 planes and walks
them backwards in time at each group's end (critic_grid gives the launch's
size).  Shared memory holds the values of k2_max_planes planes (235 in
bf16); at a longer horizon the planes past them spill to a global scratch
(k2_scratch), which the same warps read back for the walk.
K8, K9 and K10 take the f32 parameter vector and stage it to the compute
type per call, as the reference casts its parameters per call.

Every shape above is the T1 networks' (47 + 14 inputs, 12 actions).  The
library picks its shapes from the widths it is built for, and
bg_update_info reports them: at T1Standup's 434-wide critic input K3's
tile is 32 rows in bf16 (16 in f32) and K2's clusters are 4 blocks of
32-row tiles (8 of 16 in f32); at T1Serial's 23 actions the last layer's
dz is 32 wide and a sample has 64 stat slots (16 and 32 at T1's 12).

K3 and K9 run in three passes (csrc/update.cu): pass 1 per 64-row tile (32
in f32) the forward, the loss step and the input gradients, writing every
layer's input x_l and output gradient dz_l to a scratch [N, 2,400] in the
compute type; pass 2 the weight gradients dz_l^T x_l as a split-K product
over slabs of rows (row_plan), one f32 partial per slab; pass 3 the slabs'
sum in slab order.  The scratch, the slab partials and the padded weights
are allocated once per (device, N) and kept: 0.47 GB in bf16 and 0.94 GB in
f32 at N = 98,304, plus 0.71 MB per slab.

No torch.autograd.Function is involved: K3 computes the backward pass
itself, as the reference does, which has no custom_vjp around its kernel.

Layouts.  Everything is batch-major.  Parameters, gradients and both Adam
moments are flat f32 vectors in the order of ActorCritic.parameters(),
weights [out, in] as nn.Linear keeps them.  `staged` is that vector in the
compute type, so K4's staging is a cast and no transpose.  `prepare()`
builds `obsc`, the [T + 1, B, num_obs + num_priv] compute-type plane of
[obs || privileged obs] whose row T is the observation after the rollout:
K2 reads all of it, K3 and K10 its first T * B rows, the actor its first
num_obs columns.  K8 and K9 build the same rows from obs and priv.

Roundings, in the kernels and the plain versions alike: a dense layer is
operands in the compute type, f32 accumulation, the product rounded to the
compute type, then the bias added in the compute type; ELU and its
derivative are computed in f32 from the compute-type pre-activation as
z > 0 ? z : exp(z) - 1 and z > 0 ? 1 : exp(z) and rounded back; the loss
arithmetic is f32; dmu, dvalue and every input gradient are rounded to the
compute type before they go on; weight gradients accumulate f32.  In f32
mode the products are f32 FMAs, never TF32.
"""

import ctypes
import math

import numpy as np
import torch

from booster_gym_torch import kernel_build

SOURCE = "update.cu"
_LOG2PI = math.log(2.0 * math.pi)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUNCTIONS = {
    "bg_update_info": [_I, _P],
    "bg_critic_info": [_I, _I, _P],
    "bg_gae": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P,
               _P],
    "bg_grads_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                       _F, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    "bg_opt_stage": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                     _P, _P, _P, _P, _P, _P],
    "bg_values": [_I, _P, _P, _P, _P, _I, _P, _I, _P],
    "bg_grads": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _I,
                 _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "bg_policy_logp": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P],
}
INFO_KEYS = ("tile", "wpad", "scratch_width", "pass2_tiles", "pass2_rows", "smem_pass1",
             "smem_pass2", "blocks_per_sm_pass1", "blocks_per_sm_pass2", "k2_tile",
             "k2_cluster", "k2_max_planes", "k2_threads", "k2_groups", "k4_blocks",
             "k4_threads", "dz3w", "nstat")
CRITIC_INFO_KEYS = ("smem", "clusters", "blocks_per_sm")
MIN_SLAB_ROWS = 512     # fewer rows than this per slab are not worth a partial
STAT_NAMES = ("vl", "al", "bhi", "blo")   # then klsq[num_act]
# K2's device kernels in launch order: the parts that gae_timed's events
# split, and the kernels' names
K2_PARTS = ("copy", "critic")
K2_KERNELS = ("k_pad", "k2_critic")


def row_plan(n, tiles, step, slots):
    """(nslab, slab_rows): pass 2 cuts rows [0, n) into nslab slabs of
    slab_rows rows (a multiple of its `step` rows; the last may be shorter),
    slab s holding [s * slab_rows, min((s + 1) * slab_rows, n)).  As many
    slabs as the card's `slots` (SMs x resident pass-2 blocks) hold `tiles`
    x slabs blocks in one wave, never a slab under MIN_SLAB_ROWS rows
    unless there is only one."""
    nslab = max(1, min(slots // tiles, -(-n // MIN_SLAB_ROWS)))
    rows = -(-(-(-n // nslab)) // step) * step
    return -(-n // rows), rows


def k2_planes(planes, most):
    """(kept, spilled): of K2's `planes` = T + 1 planes of values, those
    that shared memory holds (at most `most`, the library's k2_max_planes)
    and those past them, which spill to the global scratch."""
    kept = min(planes, most)
    return kept, planes - kept


def critic_grid(rows, tile, cluster, clusters):
    """(units, blocks) of a K2 or K8 launch: `rows` envs (K2) or rows (K8)
    in units of `tile` (the last may be short), one unit per cluster of
    `cluster` blocks at a time, at most `clusters` clusters and never more
    clusters than units."""
    units = -(-rows // tile)
    return units, max(1, min(units, clusters)) * cluster


def param_layout(network):
    """name -> (offset, shape) of each parameter in the flat vector."""
    out, offset = {}, 0
    for name, prm in network.named_parameters():
        out[name] = (offset, tuple(prm.shape))
        offset += prm.numel()
    return out


class FusedUpdate:
    """The update kernels for one ActorCritic geometry.

    gae_launches, grads_stats_launches, opt_stage_launches, values_launches,
    grads_launches and policy_logp_launches count wrapper calls that launch
    on the card; each moves only there.  Device kernels per call: K2 two
    (the weight copy, the critic with the walk), K3 and K9 four (the weight
    copy, pass 1, pass 2, the reduce), K4 one, K8 and K10 two.  Scratch, kept
    per (device, N) and reused by every call:
    K3's and K9's pass-1 rows (N x 2,400 values of the compute type: 0.47 GB
    in bf16, 0.94 GB in f32 at N = 98,304), one f32 partial of the
    gradient per slab (0.71 MB each), the pass-1 blocks' stat partials, K2's
    block partials, arrival counter and spill (k2_scratch), K4's block sums
    (k4_part) and the padded weights (180,224 values per device)."""

    def __init__(self, network, clip_ratio, bound_coef):
        self.dtype = network.actor.dtype
        self.bf16 = int(self.dtype == torch.bfloat16)
        self.clip_ratio = float(clip_ratio)
        self.bound_coef = float(bound_coef)
        self.layout = param_layout(network)
        self.n_params = sum(int(np.prod(s)) for _, s in self.layout.values())
        self.layers = {}
        for net in ("actor", "critic"):
            mlp = getattr(network, net)
            self.layers[net] = [(self.layout[f"{net}.layers.{i}.weight"][0],
                                 self.layout[f"{net}.layers.{i}.bias"][0],
                                 layer.out_features, layer.in_features)
                                for i, layer in enumerate(mlp.layers)]
        if len(self.layers["actor"]) != 4 or len(self.layers["critic"]) != 4:
            raise ValueError("the update kernels take MLPs of three hidden layers")
        self.num_obs = self.layers["actor"][0][3]
        self.num_crit = self.layers["critic"][0][3]
        self.num_act = self.layers["actor"][3][2]
        self.logstd_off = self.layout["logstd"][0]
        self.logstd_slice = slice(self.logstd_off, self.logstd_off + self.num_act)
        a, c = self.layers["actor"], self.layers["critic"]
        self.sizes = dict(NOBS=self.num_obs, NPRIV=self.num_crit - self.num_obs,
                          NACT=self.num_act, AH1=a[0][2], AH2=a[1][2], AH3=a[2][2],
                          CH1=c[0][2], CH2=c[1][2], CH3=c[2][2])
        offs = ([l[0] for l in a] + [l[1] for l in a] + [l[0] for l in c]
                + [l[1] for l in c] + [self.logstd_off])
        self._offs = (ctypes.c_int * 17)(*offs)
        self.gae_launches = 0
        self.grads_stats_launches = 0
        self.opt_stage_launches = 0
        self.values_launches = 0
        self.grads_launches = 0
        self.policy_logp_launches = 0
        self._lib = None
        self._scratch = {}
        self._info = {}

    # -- build ------------------------------------------------------------
    def build(self):
        """Build (if needed) and load the library; returns nvcc's report."""
        path, report = kernel_build.build(SOURCE, self.sizes)
        self._lib = kernel_build.load(path, _FUNCTIONS)
        return report

    def _library(self):
        if self._lib is None:
            self.build()
        return self._lib

    @staticmethod
    def _device(device):
        """`device` with its index (the scratches are kept per device)."""
        device = torch.device(device)
        return device if device.index is not None else torch.device(
            device.type, torch.cuda.current_device())

    def info(self, device):
        """csrc/update.cu's sizes for the compute type (INFO_KEYS), its
        scratch layout ("layout": {net: [(x offset, x width, dz offset, dz
        width)] per layer, in values per row, the widths padded}) and the
        card's SM count."""
        device = self._device(device)
        if device not in self._info:
            out = (ctypes.c_int * (len(INFO_KEYS) + 32))()
            self._raise_on(self._library().bg_update_info(self.bf16, out), "update_info")
            info = dict(zip(INFO_KEYS, out))
            lay = list(out)[len(INFO_KEYS):]
            info["layout"] = {net: [tuple(lay[16 * j + 4 * l:16 * j + 4 * l + 4])
                                    for l in range(4)]
                              for j, net in enumerate(("actor", "critic"))}
            for net, layers in self.layers.items():
                for (_, xw, _, dzw), (_, _, o, i) in zip(info["layout"][net], layers):
                    if xw < i or dzw < o:
                        raise RuntimeError(f"csrc/update.cu's scratch layout {info['layout']} "
                                           f"does not hold the {net}'s widths")
            info["sms"] = torch.cuda.get_device_properties(device).multi_processor_count
            self._info[device] = info
        return self._info[device]

    def critic_info(self, device, planes):
        """K2's launch at `planes` = T + 1 planes of values, or K8's at 0
        (CRITIC_INFO_KEYS): shared memory per block, and at that size the
        card's resident clusters and resident blocks per SM."""
        device = self._device(device)
        key = (device, "critic", planes)
        if key not in self._info:
            out = (ctypes.c_int * len(CRITIC_INFO_KEYS))()
            self._raise_on(self._library().bg_critic_info(self.bf16, planes, out), "critic_info")
            self._info[key] = dict(zip(CRITIC_INFO_KEYS, out))
            if self._info[key]["clusters"] < 1:
                raise RuntimeError(f"the card holds no cluster of K2's blocks at {planes} "
                                   f"planes: {self._info[key]}")
        return self._info[key]

    def _grid(self, device, rows):
        """Blocks of a tile pass: as many as the SMs hold, at most one per
        tile."""
        info = self.info(device)
        return max(1, min(info["sms"] * info["blocks_per_sm_pass1"], -(-rows // info["tile"])))

    def _wpad(self, device):
        """The padded weights' buffer (compute type), one per device."""
        device = self._device(device)
        key = (device, "wpad")
        if key not in self._scratch:
            self._scratch[key] = torch.empty(self.info(device)["wpad"], dtype=self.dtype,
                                             device=device)
        return self._scratch[key]

    def k2_scratch(self, device, nparts, nspill=0):
        """K2's scratch, kept per device and grown as needed: {"part": the
        blocks' partial sums [2 * nparts] f32, "count": the blocks' arrival
        counter, int32, 0 between calls, "spill": [nspill] f32 (at least),
        the values of the planes past k2_max_planes}."""
        device = self._device(device)
        key = (device, "k2")
        sc = self._scratch.get(key)
        if sc is None or sc["part"].numel() < 2 * nparts:
            sc = self._scratch[key] = dict(
                part=torch.empty(2 * nparts, dtype=torch.float32, device=device),
                count=torch.zeros(1, dtype=torch.int32, device=device),
                spill=torch.empty(0, dtype=torch.float32, device=device))
        if sc["spill"].numel() < nspill:
            sc["spill"] = torch.empty(nspill, dtype=torch.float32, device=device)
        return sc

    def k4_part(self, device):
        """K4's block sums [k4_blocks] f32, kept per device."""
        device = self._device(device)
        key = (device, "k4")
        if key not in self._scratch:
            self._scratch[key] = torch.empty(self.info(device)["k4_blocks"],
                                             dtype=torch.float32, device=device)
        return self._scratch[key]

    def k3_scratch(self, device, n):
        """K3's and K9's scratch for n rows, kept per (device, n): {"rows":
        pass 1's rows, n * scratch width values of the compute type; "part":
        the slab partials [nslab, stride] f32; "part_stats": the pass-1
        blocks' stat partials; "nslab", "slab_rows", "stride", "nblk"}.
        Every slot that is read is written first by each launch."""
        device = self._device(device)
        key = (device, n)
        if key not in self._scratch:
            nblk = self._grid(device, n)
            info = self.info(device)
            nslab, slab_rows = row_plan(n, info["pass2_tiles"], info["pass2_rows"],
                                        info["sms"] * info["blocks_per_sm_pass2"])
            stride = -(-self.n_params // 32) * 32
            self._scratch[key] = dict(
                rows=torch.empty(n * info["scratch_width"], dtype=self.dtype, device=device),
                part=torch.empty((nslab, stride), dtype=torch.float32, device=device),
                part_stats=torch.empty(nblk * info["nstat"], dtype=torch.float32,
                                       device=device),
                nslab=nslab, slab_rows=slab_rows, stride=stride, nblk=nblk)
        return self._scratch[key]

    def scratch_views(self, device, n):
        """{(net, l): (x_l [n, in], dz_l [n, out])}: the rows that K3's or
        K9's last pass 1 at n rows on `device` wrote (cut_scratch)."""
        return self.cut_scratch(self.k3_scratch(device, n)["rows"], n,
                                self.info(device)["layout"])

    def cut_scratch(self, flat, n, layout):
        """{(net, l): (x_l [n, in], dz_l [n, out])} views of pass 1's flat
        rows at `layout` (info()'s), cut to the layers' true widths."""
        out = {}
        for net in ("actor", "critic"):
            for l, ((x_off, xw, dz_off, dzw), (_, _, o, i)) in enumerate(zip(
                    layout[net], self.layers[net])):
                x = flat[x_off * n:(x_off + xw) * n].view(n, xw)[:, :i]
                dz = flat[dz_off * n:(dz_off + dzw) * n].view(n, dzw)[:, :o]
                out[(net, l)] = (x, dz)
        return out

    def _check(self, name, t, shape, dtype=torch.float32):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the other tensors on a CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    @staticmethod
    def _raise_on(err, what):
        if err != 0:
            raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")

    # -- layouts ----------------------------------------------------------
    def stage(self, p):
        """The flat parameter vector in the compute type (what K4 hands from
        one mini-epoch to the next; this is mini-epoch 0's)."""
        return p.to(self.dtype)

    def prepare(self, obs, priv, act, mu_old, old_logp, obs_last=None, priv_last=None):
        """The epoch-invariant inputs, built once per iteration: obs, priv,
        act, mu_old [T, B, dim], old_logp [T, B], and optionally obs_last,
        priv_last [B, dim], without which obsc holds only the T planes (all
        K2 needs is then missing; K3 and K10 read the first T planes)."""
        obsc = torch.cat([obs, priv], dim=-1)
        if obs_last is not None:
            obsc = torch.cat([obsc, torch.cat([obs_last, priv_last], dim=-1)[None]], dim=0)
        return {"obsc": obsc.to(self.dtype).contiguous(), "act": act.contiguous(),
                "mu_old": mu_old.contiguous(), "old_logp": old_logp.contiguous()}

    def _mlp(self, staged, net):
        """([W [out, in]], [b [out]]) views of a flat vector."""
        Ws = [staged[w:w + o * i].view(o, i) for w, _, o, i in self.layers[net]]
        bs = [staged[b:b + o] for _, b, o, _ in self.layers[net]]
        return Ws, bs

    # -- the shared arithmetic of the plain versions ------------------------
    def _elu(self, z):
        zf = z.float()
        return torch.where(zf > 0, zf, torch.exp(zf) - 1.0).to(z.dtype)

    def _elu_grad(self, z):
        zf = z.float()
        return torch.where(zf > 0, torch.ones_like(zf), torch.exp(zf)).to(z.dtype)

    def _mlp_fwd(self, x, Ws, bs):
        """Dense + ELU stack on x [n, in]: (layer inputs, pre-activations)."""
        xs, zs = [x], []
        for i, (W, b) in enumerate(zip(Ws, bs)):
            z = (x.float() @ W.float().T).to(self.dtype) + b
            zs.append(z)
            if i + 1 < len(Ws):
                x = self._elu(z)
                xs.append(x)
        return xs, zs

    def _values(self, staged, x):
        """The critic's f32 values of the compute-type rows x [n, num_crit]."""
        _, zs = self._mlp_fwd(x, *self._mlp(staged, "critic"))
        return zs[-1].float()[:, 0]

    def _policy(self, staged, p, x, act):
        """Actor forward on the compute-type rows x [n, >= num_obs] and the
        log-prob of act [n, num_act]: (xs, zs, mu, logstd, var, diff, logp)."""
        xs, zs = self._mlp_fwd(x[:, :self.num_obs], *self._mlp(staged, "actor"))
        mu = zs[-1].float()
        logstd = p[self.logstd_slice]
        var = torch.exp(2.0 * logstd)
        diff = act - mu
        logp = torch.sum(-0.5 * diff * diff / var - logstd - 0.5 * _LOG2PI, dim=1)
        return xs, zs, mu, logstd, var, diff, logp

    def _mlp_bwd(self, xs, zs, Ws, dz, plan=None):
        """Backward from the last layer's dz [n, out] (compute type):
        ([dW [out, in] f32], [db [out] f32]).  With a row plan (nslab,
        slab_rows) the weight and bias gradients are pass 2's: each slab's
        dz^T x and row sum, then the slabs added in slab order."""
        dWs, dbs = [None] * len(Ws), [None] * len(Ws)
        for i in reversed(range(len(Ws))):
            dWs[i], dbs[i] = self.weight_grads_plain(xs[i], dz, plan)
            if i > 0:
                dh = (dz.float() @ Ws[i].float()).to(self.dtype)
                dz = dh * self._elu_grad(zs[i - 1])
        return dWs, dbs

    @staticmethod
    def weight_grads_plain(x, dz, plan=None):
        """(dz^T x, sum_rows dz) in f32 of x [n, in] and dz [n, out]: in one
        product, or with a row plan (nslab, slab_rows) slab by slab in slab
        order, pass 2's order."""
        if plan is None:
            return dz.float().T @ x.float(), dz.float().sum(0)
        nslab, rows = plan
        dW = db = 0.0
        for s in range(nslab):
            d, xx = dz[s * rows:(s + 1) * rows].float(), x[s * rows:(s + 1) * rows].float()
            dW, db = dW + d.T @ xx, db + d.sum(0)
        return dW, db

    # -- K2 ---------------------------------------------------------------
    def gae(self, staged, obsc, rew, nonterm, timeout_f, gamma, lam):
        """(adv_raw [T, B], returns [T, B], sum(adv), sum(adv^2)) from the
        staged weights, the [T + 1, B, dim] observation plane and the [T, B]
        f32 rewards, nonterm = 1 - (done | timeout) and timeout in {0, 1}."""
        if staged.device.type == "cpu":
            return self.gae_plain(staged, obsc, rew, nonterm, timeout_f, gamma, lam)
        return self.gae_timed(staged, obsc, rew, nonterm, timeout_f, gamma, lam, None)

    def gae_timed(self, staged, obsc, rew, nonterm, timeout_f, gamma, lam, events):
        """gae on the card.  `events`, None or len(K2_PARTS) + 1
        torch.cuda.Events that have been recorded once, are recorded on the
        stream before the weight copy and after each device kernel."""
        T, B = rew.shape
        self._check("staged", staged, (self.n_params,), self.dtype)
        self._check("obsc", obsc, (T + 1, B, self.num_crit), self.dtype)
        for name, t in (("rew", rew), ("nonterm", nonterm), ("timeout_f", timeout_f)):
            self._check(name, t, (T, B))
        if T < 1 or B < 1:
            raise ValueError(f"K2 takes T >= 1 and B >= 1, got T={T}, B={B}")
        dev = staged.device
        info = self.info(dev)
        splanes, spilled = k2_planes(T + 1, info["k2_max_planes"])
        groups, nblk = critic_grid(B, info["k2_tile"], info["k2_cluster"],
                                   self.critic_info(dev, splanes)["clusters"])
        ew = info["k2_tile"] // info["k2_cluster"]
        sc = self.k2_scratch(dev, groups * info["k2_cluster"] * info["k2_groups"],
                             nblk * spilled * ew)
        adv = torch.empty((T, B), dtype=torch.float32, device=dev)
        ret = torch.empty((T, B), dtype=torch.float32, device=dev)
        sums = torch.empty(2, dtype=torch.float32, device=dev)
        err = self._library().bg_gae(
            self.bf16, staged.data_ptr(), self._offs, self._wpad(dev).data_ptr(), obsc.data_ptr(),
            rew.data_ptr(), nonterm.data_ptr(), timeout_f.data_ptr(), sc["part"].data_ptr(),
            sc["count"].data_ptr(), sc["spill"].data_ptr() if spilled else None, adv.data_ptr(),
            ret.data_ptr(), sums.data_ptr(), T, B,
            float(gamma), float(lam), nblk, None if events is None else (
                ctypes.c_void_p * len(events))(*(e.cuda_event for e in events)),
            torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(err, "gae")
        self.gae_launches += 1
        return adv, ret, sums[0], sums[1]

    def gae_plain(self, staged, obsc, rew, nonterm, timeout_f, gamma, lam):
        T, B = rew.shape
        values = self._values(staged, obsc.reshape((T + 1) * B, self.num_crit)).view(T + 1, B)
        nextv, carry = values[T], torch.zeros_like(values[T])
        adv, ret = torch.empty_like(rew), torch.empty_like(rew)
        for t in reversed(range(T)):
            v = values[t]
            rwd = timeout_f[t] * v + (1.0 - timeout_f[t]) * rew[t]
            delta = rwd + gamma * nonterm[t] * nextv - v
            carry = delta + gamma * lam * nonterm[t] * carry
            nextv = v
            adv[t] = carry
            ret[t] = v + carry
        return adv, ret, adv.sum(), (adv * adv).sum()

    # -- K3 ---------------------------------------------------------------
    def grads_stats(self, staged, p, prep, adv_raw, returns, adv_mean, adv_rstd, self_old,
                    n_total=None):
        """(g, stats, mu, logp): the flat f32 gradient of value loss + actor
        loss + bound_coef * bound loss in the parameters' order (the entropy
        term is K4's), stats = {vl, al, bhi, blo, klsq [num_act]} as sums
        over the batch, and the forward's mu [N, num_act] and logp [N].
        The loss means divide by n_total rows (default N): a data-parallel
        rank passes the global count, and the ranks' g summed is then the
        whole batch's gradient.

        adv_raw and returns hold N values; the first N rows of prep's
        tensors are read.  adv_mean and adv_rstd are 0-dim tensors.  p gives
        logstd in f32.  self_old marks the first mini-epoch: the old policy
        is this forward itself, so the ratio is exactly 1 and klsq exactly
        0, and the caller keeps mu and logp as the old policy.

        On the card one call is four device kernels: the weight copy, pass
        1, pass 2 and the reduce."""
        if staged.device.type == "cpu":
            return self.grads_stats_plain(staged, p, prep, adv_raw, returns, adv_mean,
                                          adv_rstd, self_old, n_total)
        return self.grads_stats_timed(staged, p, prep, adv_raw, returns, adv_mean, adv_rstd,
                                      self_old, None, n_total)

    def grads_stats_timed(self, staged, p, prep, adv_raw, returns, adv_mean, adv_rstd,
                          self_old, events, n_total=None):
        """grads_stats on the card.  `events`, None or four
        torch.cuda.Events that have been recorded once, are recorded on the
        stream before the weight copy and after pass 1, pass 2 and the
        reduce: the passes' times within a whole call, for measurement."""
        n, na = adv_raw.numel(), self.num_act
        n_total = n if n_total is None else int(n_total)
        if n_total < n:
            raise ValueError(f"n_total {n_total} is below the {n} rows")
        obsc = prep["obsc"]
        self._check("staged", staged, (self.n_params,), self.dtype)
        self._check("p", p, (self.n_params,))
        if obsc.numel() < n * self.num_crit or obsc.shape[-1] != self.num_crit:
            raise ValueError(f"obsc {tuple(obsc.shape)} holds fewer than {n} rows of "
                             f"{self.num_crit}")
        self._check("obsc", obsc, obsc.shape, self.dtype)
        for name, t, k in (("act", prep["act"], na), ("mu_old", prep["mu_old"], na),
                           ("old_logp", prep["old_logp"], 1), ("adv_raw", adv_raw, 1),
                           ("returns", returns, 1)):
            if t.numel() != n * k:
                raise ValueError(f"{name} must hold {n * k} values, got {t.numel()}")
            self._check(name, t, t.shape)
        dev = staged.device
        norm = torch.stack([adv_mean, adv_rstd]).float()
        self._check("adv_mean, adv_rstd", norm, (2,))
        sc = self.k3_scratch(dev, n)
        g = torch.empty(self.n_params, dtype=torch.float32, device=dev)
        stats = torch.empty(4 + na, dtype=torch.float32, device=dev)
        mu = torch.empty((n, na), dtype=torch.float32, device=dev)
        logp = torch.empty(n, dtype=torch.float32, device=dev)
        err = self._library().bg_grads_stats(
            self.bf16, staged.data_ptr(), p.data_ptr(), self._offs, self._wpad(dev).data_ptr(),
            obsc.data_ptr(), prep["act"].data_ptr(), prep["mu_old"].data_ptr(),
            prep["old_logp"].data_ptr(), adv_raw.data_ptr(), returns.data_ptr(), norm.data_ptr(),
            int(bool(self_old)), n, n_total, 1.0 - self.clip_ratio, 1.0 + self.clip_ratio,
            self.bound_coef / (n_total * na), sc["rows"].data_ptr(), sc["part"].data_ptr(),
            sc["part_stats"].data_ptr(), sc["stride"], sc["nslab"], sc["slab_rows"],
            self.n_params, g.data_ptr(), stats.data_ptr(), mu.data_ptr(), logp.data_ptr(),
            sc["nblk"], None if events is None else (ctypes.c_void_p * 4)(
                *(e.cuda_event for e in events)),
            torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(err, "grads_stats")
        self.grads_stats_launches += 1
        st = {k: stats[i] for i, k in enumerate(STAT_NAMES)}
        st["klsq"] = stats[4:]
        return g, st, mu, logp

    def grads_stats_plain(self, staged, p, prep, adv_raw, returns, adv_mean, adv_rstd,
                          self_old, n_total=None):
        n, na = adv_raw.numel(), self.num_act
        n_total = n if n_total is None else int(n_total)
        old = (None, None) if self_old else (prep["old_logp"].reshape(n),
                                             prep["mu_old"].reshape(n, na))
        g, stats, mu, _, logp = self._loss_grads(
            staged, p, prep["obsc"].reshape(-1, self.num_crit)[:n], prep["act"].reshape(n, na),
            (adv_raw.reshape(n) - adv_mean) * adv_rstd, returns.reshape(n), *old, n_total)
        return g, stats, mu, logp

    def _loss_grads(self, staged, p, x, act, adv, ret, old_logp, mu_old, n_total, plan=None):
        """K3's and K9's arithmetic on the rows x [n, num_crit] (compute
        type), act [n, num_act] and adv, ret [n] (f32): (g, stats, mu, val,
        logp).  old_logp None makes the forward its own old policy, mu_old
        None its own mu for klsq; the loss means divide by n_total.  A row
        plan sums the weight gradients as pass 2 does (weight_grads_plain)."""
        n, na = adv.numel(), self.num_act
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=staged.device)
        aW, _ = self._mlp(staged, "actor")
        cW, cb = self._mlp(staged, "critic")
        xa, za, mu, logstd, var, diff, logp = self._policy(staged, p, x, act)
        xc, zc = self._mlp_fwd(x, cW, cb)
        val = zc[-1].float()[:, 0]
        old_logp = logp if old_logp is None else old_logp
        mu_old = mu if mu_old is None else mu_old
        ratio = torch.exp(logp - old_logp)
        lo, hi = f32(1.0 - self.clip_ratio), f32(1.0 + self.clip_ratio)
        one, half, zero = f32(1.0), f32(0.5), f32(0.0)
        surr = -adv * ratio
        surr_c = -adv * torch.minimum(torch.maximum(ratio, lo), hi)
        # d max(s, sc)/ds: 1 where s > sc, 0.5 at ties
        gs = torch.where(surr > surr_c, one, torch.where(surr < surr_c, zero, half))
        # d clip(r)/dr = d min(max(r, lo), hi)/dr: 0.5 on either bound
        cg = (torch.where(ratio > lo, one, torch.where(ratio == lo, half, zero))
              * torch.where(ratio < hi, one, torch.where(ratio == hi, half, zero)))
        inv_n = one / n_total
        dlogp = ((gs + (1.0 - gs) * cg) * (-adv) * inv_n * ratio)[:, None]
        dmu = dlogp * diff / var
        dlogstd = torch.sum(dlogp * (diff * diff / var - 1.0), dim=0)
        b_hi = torch.clamp(mu - 1.0, min=0.0)
        b_lo = torch.clamp(mu + 1.0, max=0.0)
        dmu = dmu + (2.0 * b_hi + 2.0 * b_lo) * (self.bound_coef / (n_total * na))
        dval = 2.0 * (val - ret) * inv_n
        stats = {"vl": torch.sum(torch.square(val - ret)),
                 "al": torch.sum(torch.maximum(surr, surr_c)),
                 "bhi": torch.sum(torch.square(b_hi)), "blo": torch.sum(torch.square(b_lo)),
                 "klsq": torch.sum(torch.square(mu - mu_old), dim=0)}

        g = torch.zeros(self.n_params, dtype=torch.float32, device=staged.device)
        for net, xs, zs, Ws, dz in (("actor", xa, za, aW, dmu.to(self.dtype)),
                                    ("critic", xc, zc, cW, dval.to(self.dtype)[:, None])):
            dWs, dbs = self._mlp_bwd(xs, zs, Ws, dz, plan)
            for (w, b, o, i), dW, db in zip(self.layers[net], dWs, dbs):
                g[w:w + o * i] = dW.reshape(-1)
                g[b:b + o] = db
        g[self.logstd_slice] = dlogstd
        return g, stats, mu, val, logp

    # -- K4 ---------------------------------------------------------------
    def opt_stage(self, g, p, m, v, cnt, lr, entropy_coef, b1, b2, eps, max_norm):
        """One optimizer step on the flat vectors: the entropy gradient
        (entropy_coef per logstd dim) added before the global-norm clip,
        then Adam with optax's formulas at step cnt + 1.  lr is a 0-dim
        tensor, read on the device.  Returns new tensors (p', m', v',
        staged'); staged' is p' in the compute type."""
        if g.device.type == "cpu":
            return self.opt_stage_plain(g, p, m, v, cnt, lr, entropy_coef, b1, b2, eps,
                                        max_norm)
        for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
            self._check(name, t, (self.n_params,))
        self._check("lr", lr, ())
        for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned (K4 loads float4)")
        dev = g.device
        p2, m2, v2 = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
        staged = torch.empty(self.n_params, dtype=self.dtype, device=dev)
        part = self.k4_part(dev)
        err = self._library().bg_opt_stage(
            self.bf16, g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), lr.data_ptr(),
            int(cnt), self.logstd_off, self.n_params, float(entropy_coef), float(b1),
            1.0 - b1, float(b2), 1.0 - b2, math.log(b1), math.log(b2), float(eps),
            float(max_norm), part.data_ptr(), p2.data_ptr(), m2.data_ptr(), v2.data_ptr(),
            staged.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(err, "opt_stage")
        self.opt_stage_launches += 1
        return p2, m2, v2, staged

    def opt_stage_plain(self, g, p, m, v, cnt, lr, entropy_coef, b1, b2, eps, max_norm):
        g = g.clone()
        g[self.logstd_slice] += entropy_coef
        g_norm = torch.sqrt(torch.sum(g * g))
        g = g * torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
        cnt2 = torch.tensor(float(cnt + 1), dtype=torch.float32, device=g.device)
        bc1 = 1.0 - torch.exp(cnt2 * math.log(b1))
        bc2 = 1.0 - torch.exp(cnt2 * math.log(b2))
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * (g * g)
        p2 = p + (-lr) * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
        return p2, m2, v2, p2.to(self.dtype)

    # -- K8 ---------------------------------------------------------------
    def _obsc_rows(self, obs, priv):
        """[obs || priv] as contiguous compute-type rows [n, num_crit]."""
        return torch.cat([obs.reshape(-1, self.num_obs),
                          priv.reshape(-1, self.num_crit - self.num_obs)],
                         dim=1).to(self.dtype).contiguous()

    def values(self, p, obs, priv):
        """critic(concat(obs, priv)) in f32, shaped like obs' leading
        dimensions, from the f32 parameter vector p."""
        if p.device.type == "cpu":
            return self.values_plain(p, obs, priv)
        self._check("p", p, (self.n_params,))
        staged, obsc = self.stage(p), self._obsc_rows(obs, priv)
        n, dev = obsc.shape[0], p.device
        self._check("obsc", obsc, (n, self.num_crit), self.dtype)
        if n < 1:
            raise ValueError("values takes at least one row")
        info = self.info(dev)
        _, nblk = critic_grid(n, info["k2_tile"], info["k2_cluster"],
                              self.critic_info(dev, 0)["clusters"])
        val = torch.empty(n, dtype=torch.float32, device=dev)
        err = self._library().bg_values(
            self.bf16, staged.data_ptr(), self._offs, self._wpad(dev).data_ptr(), obsc.data_ptr(),
            n, val.data_ptr(), nblk, torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(err, "values")
        self.values_launches += 1
        return val.view(obs.shape[:-1])

    def values_plain(self, p, obs, priv):
        return self._values(self.stage(p), self._obsc_rows(obs, priv)).view(obs.shape[:-1])

    # -- K9 ---------------------------------------------------------------
    def grads(self, p, obs, priv, act, adv, returns, old_logp, n_total=None):
        """(g, mu, values): the flat f32 gradient of value loss + actor loss
        + bound_coef * bound loss at the f32 parameters p (the entropy term
        is left out, as in grads_stats), with adv used as given and the loss
        means over n_total rows (default: the row count, which still masks);
        mu [..., num_act] and values [...] in obs' leading shape, rounded to
        the compute type and returned as f32."""
        lead = obs.shape[:-1]
        n, na = int(np.prod(lead)), self.num_act
        n_total = n if n_total is None else int(n_total)
        if p.device.type == "cpu":
            return self.grads_plain(p, obs, priv, act, adv, returns, old_logp, n_total)
        self._check("p", p, (self.n_params,))
        staged, obsc = self.stage(p), self._obsc_rows(obs, priv)
        act, adv, ret, old_logp = (t.reshape(-1).contiguous()
                                   for t in (act, adv, returns, old_logp))
        for name, t, k in (("act", act, na), ("adv", adv, 1), ("returns", ret, 1),
                           ("old_logp", old_logp, 1)):
            self._check(name, t, (n * k,))
        dev = p.device
        sc = self.k3_scratch(dev, n)
        g = torch.empty(self.n_params, dtype=torch.float32, device=dev)
        stats = torch.empty(4 + na, dtype=torch.float32, device=dev)
        mu = torch.empty((n, na), dtype=self.dtype, device=dev)
        val = torch.empty(n, dtype=self.dtype, device=dev)
        err = self._library().bg_grads(
            self.bf16, staged.data_ptr(), p.data_ptr(), self._offs, self._wpad(dev).data_ptr(),
            obsc.data_ptr(), act.data_ptr(), old_logp.data_ptr(), adv.data_ptr(), ret.data_ptr(),
            n, n_total, 1.0 - self.clip_ratio, 1.0 + self.clip_ratio,
            self.bound_coef / (n_total * na), sc["rows"].data_ptr(), sc["part"].data_ptr(),
            sc["part_stats"].data_ptr(), sc["stride"], sc["nslab"], sc["slab_rows"],
            self.n_params, g.data_ptr(), stats.data_ptr(), mu.data_ptr(), val.data_ptr(),
            sc["nblk"], torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(err, "grads")
        self.grads_launches += 1
        return g, mu.float().view(lead + (na,)), val.float().view(lead)

    def grads_plain(self, p, obs, priv, act, adv, returns, old_logp, n_total=None):
        lead = obs.shape[:-1]
        n, na = int(np.prod(lead)), self.num_act
        n_total = n if n_total is None else int(n_total)
        g, _, mu, val, _ = self._loss_grads(
            self.stage(p), p, self._obsc_rows(obs, priv), act.reshape(n, na), adv.reshape(n),
            returns.reshape(n), old_logp.reshape(n), None, n_total)
        rnd = lambda t: t.to(self.dtype).float()
        return g, rnd(mu).view(lead + (na,)), rnd(val).view(lead)

    # -- K10 --------------------------------------------------------------
    def policy_old_logp(self, p, prep):
        """(mu [N, num_act], logp [N]), f32: the actor at the f32 parameters
        p on prep's first N = old_logp.numel() rows, and the log-prob of
        prep's actions, through K3's forward."""
        n, na = prep["old_logp"].numel(), self.num_act
        if p.device.type == "cpu":
            return self.policy_old_logp_plain(p, prep)
        obsc, act = prep["obsc"], prep["act"]
        self._check("p", p, (self.n_params,))
        if obsc.numel() < n * self.num_crit or obsc.shape[-1] != self.num_crit:
            raise ValueError(f"obsc {tuple(obsc.shape)} holds fewer than {n} rows of "
                             f"{self.num_crit}")
        self._check("obsc", obsc, obsc.shape, self.dtype)
        self._check("act", act, act.shape)
        if act.numel() != n * na:
            raise ValueError(f"act must hold {n * na} values, got {act.numel()}")
        dev, staged = p.device, self.stage(p)
        mu = torch.empty((n, na), dtype=torch.float32, device=dev)
        logp = torch.empty(n, dtype=torch.float32, device=dev)
        err = self._library().bg_policy_logp(
            self.bf16, staged.data_ptr(), p.data_ptr(), self._offs, self._wpad(dev).data_ptr(),
            obsc.data_ptr(),
            act.data_ptr(), n, mu.data_ptr(), logp.data_ptr(), self._grid(dev, n),
            torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(err, "policy_old_logp")
        self.policy_logp_launches += 1
        return mu, logp

    def policy_old_logp_plain(self, p, prep):
        n, na = prep["old_logp"].numel(), self.num_act
        x = prep["obsc"].reshape(-1, self.num_crit)[:n]
        _, _, mu, *_, logp = self._policy(self.stage(p), p, x, prep["act"].reshape(n, na))
        return mu, logp
