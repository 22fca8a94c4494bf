"""The port's counterparts of the repository's tools/ scripts, one module
each under the same name, run as python -m booster_gym_torch.tools.<name>:

  train_curve            the reward curve of a T1 run, one row per 50 iterations
  ab_divergence          the env-semantics A/B arms (still selection, curriculum)
  standup_probe          a standup policy's height/uprightness envelope in T1Standup
  standup_wrapper_probe  the same through the deploy wrapper (StandupPolicy)
  standup_mujoco         the standup policy's get-ups in MuJoCo (CPU)
  view                   the live viewer: the port's state mirrored into MuJoCo (CPU)

Each runs on cuda unless given --device cpu, and without a card exits
non-zero rather than falling back to the CPU.  The robot comes from
--asset_file (and --mujoco_file where the task reads an MJCF), else from
the stand-ins of booster_gym_torch/testing.py, written to a temporary
directory; every record names the robot it ran.
"""

import os
import sys
import tempfile

STANDIN = "T1-shaped stand-in (booster_gym_torch/testing.py write_t1_shaped_urdf)"
SERIAL_STANDIN = ("23-DoF serial stand-in (booster_gym_torch/testing.py write_t1_serial_urdf, "
                  "write_t1_serial_mjcf)")


def device_or_exit(device):
    """torch.device(device); exits with status 2 and the reason on stderr
    where it names cuda and no card is present."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available; pass --device cpu to run on the CPU", file=sys.stderr)
        sys.exit(2)
    return dev


def card(device):
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    from booster_gym_torch.testing import card_line

    return card_line()


def t1_robot(asset_file):
    """(urdf path, robot name for the records): --asset_file, else the
    T1-shaped stand-in written to a temporary directory."""
    if asset_file:
        return asset_file, asset_file
    from booster_gym_torch.testing import write_t1_shaped_urdf

    return write_t1_shaped_urdf(tempfile.mkdtemp(prefix="t1_standin_")), STANDIN


def serial_robot(asset_file, mujoco_file):
    """(urdf, mjcf, robot name): the given files, else the 23-DoF serial
    stand-ins written to a temporary directory."""
    if asset_file and mujoco_file:
        return asset_file, mujoco_file, f"{asset_file}, {mujoco_file}"
    if asset_file or mujoco_file:
        raise SystemExit("give both --asset_file and --mujoco_file, or neither")
    from booster_gym_torch.testing import write_t1_serial_mjcf, write_t1_serial_urdf

    d = tempfile.mkdtemp(prefix="t1_serial_standin_")
    return write_t1_serial_urdf(d), write_t1_serial_mjcf(d), SERIAL_STANDIN


def open_out(path):
    """Make the output's directory and return the path."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def load_params(network, path):
    """Load the actor-critic's parameters from a checkpoint: the port's
    model_<it>.pt, or the JAX package's model_<it>.ckpt (through
    convert.params_from_flax)."""
    from booster_gym_torch.convert import params_from_flax
    from booster_gym_torch.utils.recorder import load_checkpoint

    saved = load_checkpoint(path)
    network.load_state_dict(params_from_flax(saved["params"]) if "opt_state" in saved
                            else saved["params"])
