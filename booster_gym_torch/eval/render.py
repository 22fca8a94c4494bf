"""Offline video rendering from logged trajectories (the port's copy of
booster_gym_tpu/eval/render.py, with the port's asset lookup).

Simulation logs states; rendering happens afterwards from the states,
never in the hot loop, with MuJoCo's offscreen renderer in a pool of
worker processes.  It replaces the reference's two rendering paths, the
in-sim camera video and the MuJoCo batch state-renderer.

Needs a GL backend: on a headless host Mesa's software EGL is selected
before mujoco is imported (MUJOCO_GL binds at import time, and probing
backends after a failed bind aborts the process, so there is one attempt
per process).  Raises a clear error when no backend works.
"""

import multiprocessing as mp
import os

import numpy as np

if "MUJOCO_GL" not in os.environ and not os.environ.get("DISPLAY"):
    os.environ["MUJOCO_GL"] = "egl"


def _gl_available():
    """One offscreen-render probe, in a SUBPROCESS.

    Two reasons it must not run in the caller's process: (1) mujoco binds
    its GL module on first use, and a failed glfw/X11 bind aborts the
    interpreter via libc++ rather than raising; (2) a live Mesa EGL
    (llvmpipe) context and TensorFlow's bundled LLVM crash the process when
    both are loaded — observed as flaky SIGSEGV/SIGABRT in pytest runs that
    mixed this probe with TensorBoard imports."""
    import subprocess
    import sys

    code = (
        "import mujoco\n"
        "m = mujoco.MjModel.from_xml_string('<mujoco><worldbody/></mujoco>')\n"
        "r = mujoco.Renderer(m, 32, 32)\n"
        "r.close()\n"
        "print('GL_PROBE_OK')\n")
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, timeout=120)
        return out.returncode == 0 and b"GL_PROBE_OK" in out.stdout
    except Exception:
        return False


def _render_worker(mjcf_path, qpos_chunk, width, height, out_npy):
    """Render a state chunk and write frames to out_npy.

    Results travel through files, not an mp.Queue: multi-MB frame payloads
    through a Queue's feeder-thread/pipe proved deadlock-prone with GL
    children, and files make a crashed worker trivially
    detectable (missing file)."""
    import mujoco

    model = mujoco.MjModel.from_xml_path(mjcf_path)
    data = mujoco.MjData(model)
    renderer = mujoco.Renderer(model, height, width)
    cam = mujoco.MjvCamera()
    frames = []
    for qpos in qpos_chunk:
        data.qpos[:] = qpos
        mujoco.mj_forward(model, data)
        cam.lookat[:] = data.qpos[:3]
        cam.distance = 3.0
        cam.elevation = -20
        renderer.update_scene(data, cam)
        frames.append(renderer.render().copy())
    tmp = out_npy + ".tmp.npy"
    np.save(tmp, np.stack(frames) if frames else np.zeros((0, height, width, 3), np.uint8))
    os.replace(tmp, out_npy)


def render_states_to_video(mjcf_path, qpos_seq, out_path, fps=50,
                           width=640, height=480, workers=4):
    """Batch-render a qpos sequence to mp4 using a process pool (the
    reference's mp.Process + Queue pattern, play_mujoco.py:533-688)."""
    if not _gl_available():
        raise RuntimeError(
            "no GL backend (EGL/osmesa) available for offscreen rendering")
    import tempfile

    qpos_seq = np.asarray(qpos_seq)
    chunks = np.array_split(qpos_seq, workers)
    # spawn, not fork: the parent's GL probe leaves an initialized EGL
    # context that forked children inherit in a broken state (render calls
    # deadlock); spawned children re-import mujoco and bind EGL fresh
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="render_") as tmpdir:
        outs = [os.path.join(tmpdir, f"chunk_{i}.npy") for i in range(len(chunks))]
        procs = []
        for i, chunk in enumerate(chunks):
            p = ctx.Process(
                target=_render_worker,
                args=(mjcf_path, chunk, width, height, outs[i]))
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
        missing = [o for o in outs if not os.path.exists(o)]
        if missing:
            raise RuntimeError(
                f"{len(missing)} render worker(s) died without output")
        _write_video(out_path, (f for o in outs for f in np.load(o)), fps)
    return out_path


def _write_video(out_path, frames, fps):
    """cv2.VideoWriter (the reference's writer, play_mujoco.py:653-688) —
    imageio's mp4 backends (ffmpeg/pyav) are often missing.  cv2
    fails SILENTLY (no file, no error) on a missing directory or codec, so
    create the directory and verify the artifact exists afterwards."""
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    try:
        import cv2
    except ImportError:
        import imageio

        with imageio.get_writer(out_path, fps=fps) as writer:
            for frame in frames:
                writer.append_data(frame)
        return
    writer = None
    n = 0
    for frame in frames:
        if writer is None:
            h, w = frame.shape[:2]
            writer = cv2.VideoWriter(
                out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            if not writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter failed to open {out_path}")
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        n += 1
    if writer is not None:
        writer.release()
    if n and (not os.path.exists(out_path) or os.path.getsize(out_path) == 0):
        raise RuntimeError(f"video writer produced no file at {out_path}")


def render_trajectory(cfg, traj, env_idx=0, out_dir="videos"):
    """Render one env's logged trajectory (Runner.play's list of per-step
    dicts of root_pos, root_quat and q) to an mp4 under `out_dir`, at the
    control rate."""
    import time as _time

    from booster_gym_torch.envs.t1 import _resolve_asset

    os.makedirs(out_dir, exist_ok=True)
    qpos_seq = [
        np.concatenate([t["root_pos"][env_idx], t["root_quat"][env_idx], t["q"][env_idx]])
        for t in traj
    ]
    name = _time.strftime("%Y-%m-%d-%H-%M-%S.mp4", _time.localtime())
    out = os.path.join(out_dir, name)
    mjcf = _resolve_asset(cfg["asset"]["mujoco_file"])
    dt = cfg["control"]["decimation"] * cfg["sim"]["dt"]
    return render_states_to_video(mjcf, qpos_seq, out, fps=int(1.0 / dt))
