"""T1.step on one card as CUDA graphs: its five parts captured once and
replayed.

Op by op, the env step launches 500-600 small kernels a control step
from the host, and the host's pace sets the rollout's.  StepGraphs
captures each part of the step (env.physics, env.post_physics,
env.reward, env.reset, env.observe: T1._step_parts) as a CUDA graph, in
order and into one memory pool, each part's inputs the previous part's
outputs.  A call then copies the state and the actions into the first
part's inputs (one batched copy), replays the five graphs, each inside its
part's span, and copies the outputs into fresh tensors (one batched copy),
which the caller owns: a later call never writes them.

A capture holds for one params object, one generator object and one
layout of the inputs: the storages their tensors share, and each tensor's
dtype, shape, strides and place in its storage (Layout).  The copies move
the part of each storage that its tensors cover, from a 16-byte boundary,
so a replay computes on inputs laid out and aligned as the caller's, and
the caller gets outputs laid out as the op-by-op step lays them out: a
kernel's reduction order, which can follow the strides and the alignment
it reads, is the op-by-op step's.  T1.step captures a layout that two
calls in a row bring with the same params and generator (the step's own
outputs keep their layout, so a rollout captures at its first steps and
replays from then on); a call that brings another runs op by op.

The generator is registered with every graph: a replay draws at the
generator's offset when it is replayed and advances it as the op-by-op
part would, so the draws are the op-by-op step's.  The kernels' launch
counters (SubstepKernel.launches, .fused_sampler_launches) count in Python
at each call, so a capture notes what its part counted and each replay
adds it.
"""

import dataclasses

import torch

from booster_gym_torch.utils.spans import span


def tensors(tree):
    """The tensors of a tree of dataclasses, dicts, tuples and lists, in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in tensors(x)]


def rebuild(tree, it):
    """`tree` with its tensors replaced, in order, by those the iterator
    `it` yields."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: rebuild(getattr(tree, f.name), it)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(x, it) for x in tree)
    return tree


def _extent(t):
    """The bytes [lo, hi) of its storage that tensor t covers."""
    lo = t.storage_offset() * t.itemsize
    if t.numel() == 0:
        return lo, lo
    return lo, lo + (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.itemsize


def _words(storages, regions):
    """Each storage's byte region [lo, hi) as a flat tensor of the widest
    integer type that divides every region's start and length (the
    batched copy's elements)."""
    dtype = next(d for d in (torch.int64, torch.int32, torch.int16, torch.uint8)
                 if all(lo % d.itemsize == 0 and (hi - lo) % d.itemsize == 0
                        for lo, hi in regions))
    return [torch.empty(0, dtype=dtype, device=s.device).set_(
                s, lo // dtype.itemsize, ((hi - lo) // dtype.itemsize,))
            for s, (lo, hi) in zip(storages, regions)]


class Layout:
    """Where a list of tensors lies: the distinct storages under them, in
    order of first use, each cut to the region its tensors cover (from 16
    bytes' alignment below their first byte, so that a copy keeps every
    tensor's alignment), as `words` (_words), and each tensor's (storage,
    dtype, shape, strides, offset in the region).  Two lists with equal
    `key`s are laid out alike: a view at another place in a larger buffer
    (a step's actions cut from a sequence) is laid out as the last."""

    def __init__(self, ts):
        index, self.storages, regions, slots = {}, [], [], []
        for t in ts:
            s = t.untyped_storage()
            i = index.setdefault(s.data_ptr(), len(index))
            lo, hi = _extent(t)
            if i == len(self.storages):
                self.storages.append(s)
                regions.append((lo, hi))
            regions[i] = (min(regions[i][0], lo), max(regions[i][1], hi))
            slots.append((i, t))
        self.regions = [(lo - lo % 16, min(-(-hi // 16) * 16, s.nbytes()))
                        for s, (lo, hi) in zip(self.storages, regions)]
        self.slots = [(i, t.dtype, t.shape, t.stride(),
                       t.storage_offset() - self.regions[i][0] // t.itemsize)
                      for i, t in slots]
        self.key = (tuple(hi - lo for lo, hi in self.regions), tuple(self.slots))
        self.words = _words(self.storages, self.regions)

    def clone(self):
        """The tensors laid out as these are, in fresh storages that hold a
        copy of their regions (one batched copy)."""
        fresh = [torch.empty(hi - lo, dtype=torch.uint8, device=s.device).untyped_storage()
                 for s, (lo, hi) in zip(self.storages, self.regions)]
        torch._foreach_copy_(_words(fresh, [(0, hi - lo) for lo, hi in self.regions]),
                             self.words)
        return [torch.empty(0, dtype=dtype, device=fresh[i].device).set_(fresh[i], off, shape,
                                                                          stride)
                for i, dtype, shape, stride, off in self.slots]


class StepGraphs:
    """The step's parts captured as CUDA graphs for one params object, one
    generator object and one layout of the step's inputs.

    inputs: the (state, actions) whose layout `layout` is; parts: [(span
    name, part(params, gen, carry))], each part reading and updating the
    carry dict, the first from {"state", "actions"}; result(carry): the
    step's outputs; counters: the (object, attribute) launch counters the
    parts move.  Captures on construction, on a side stream of the current
    card; replay(layout) runs a step."""

    def __init__(self, params, gen, inputs, layout, parts, result, counters):
        self.params, self.gen, self.key = params, gen, layout.key
        static = layout.clone()
        self._inputs = Layout(static).words
        state, actions = rebuild(inputs, iter(static))
        carry = {"state": state, "actions": actions}
        self.graphs, pool = [], None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for name, part in parts:
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(gen)
                before = [getattr(obj, attr) for obj, attr in counters]
                graph.capture_begin(pool=pool)
                try:
                    part(params, gen, carry)
                finally:
                    graph.capture_end()
                pool = graph.pool()
                # the capture launched nothing: its counts go to each replay
                moved = []
                for (obj, attr), n in zip(counters, before):
                    if getattr(obj, attr) != n:
                        moved.append((obj, attr, getattr(obj, attr) - n))
                        setattr(obj, attr, n)
                self.graphs.append((name, graph, moved))
        torch.cuda.current_stream().wait_stream(side)
        self.outputs = result(carry)
        self._outputs = Layout(tensors(self.outputs))

    def serves(self, params, gen, layout):
        """Whether this capture replays a call with these arguments."""
        return self.params is params and self.gen is gen and self.key == layout.key

    def replay(self, layout):
        """One step from the inputs laid out as `layout`: copy them in,
        replay the parts, each in its span, and return copies of the
        outputs."""
        torch._foreach_copy_(self._inputs, layout.words)
        for name, graph, moved in self.graphs:
            with span(name):
                graph.replay()
            for obj, attr, n in moved:
                setattr(obj, attr, getattr(obj, attr) + n)
        return rebuild(self.outputs, iter(self._outputs.clone()))
