"""LowCmd builders (reference: deploy/utils/command.py:19-35)."""

from booster_gym_torch.deploy.sdk import NUM_JOINTS


def init_low_cmd(low_cmd):
    for i in range(NUM_JOINTS):
        m = low_cmd.motor_cmd[i]
        m.q = 0.0
        m.dq = 0.0
        m.tau = 0.0
        m.kp = 0.0
        m.kd = 0.0
        m.weight = 0.0
    return low_cmd


def create_prepare_cmd(low_cmd, cfg):
    """Stiff prepare-pose command (entering custom mode)."""
    init_low_cmd(low_cmd)
    for i in range(NUM_JOINTS):
        m = low_cmd.motor_cmd[i]
        m.kp = cfg["prepare"]["stiffness"][i]
        m.kd = cfg["prepare"]["damping"][i]
        m.q = cfg["prepare"]["default_qpos"][i]
    return low_cmd


def create_first_frame_rl_cmd(low_cmd, cfg):
    """First RL frame: running gains + default pose."""
    init_low_cmd(low_cmd)
    for i in range(NUM_JOINTS):
        m = low_cmd.motor_cmd[i]
        m.kp = cfg["common"]["stiffness"][i]
        m.kd = cfg["common"]["damping"][i]
        m.q = cfg["common"]["default_qpos"][i]
    return low_cmd
