"""Deploy entry point: python -m booster_gym_torch.deploy.main --config=T1.yaml
[--net=IP] [--standup] [--upper-body=policy|teleop|sine]
[--teleop-uri=ws://HOST:PORT] [--mock]

(reference entry points: deploy/deploy.py:425-458, deploy_standup.py, and
upper_body_controller.py's main-loop wiring.)  --upper-body=teleop starts
the WebSocket arm client on its own thread (reconnecting, stale-holding);
--mock runs against the in-process MockRobot emulator instead of the SDK
(the Webots rung of the reference's sim-to-real ladder without Webots).
The flags are those of python -m booster_gym_tpu.deploy.main; this copy
imports nothing of JAX.
"""

import argparse
import os
import signal
import sys
import time

import numpy as np
import yaml

from booster_gym_torch.deploy.controller import Controller, UpperBodyMode
from booster_gym_torch.deploy.remote_control import RemoteControlService
from booster_gym_torch.deploy.sdk import SdkRobot


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="T1.yaml")
    parser.add_argument("--net", default="127.0.0.1")
    parser.add_argument("--standup", action="store_true",
                        help="enable the fall-recovery state machine")
    parser.add_argument("--upper-body", default="policy",
                        choices=[m.value for m in UpperBodyMode])
    parser.add_argument("--teleop-uri", default="ws://localhost:8765",
                        help="VR tracking server (with --upper-body=teleop)")
    parser.add_argument("--mock", action="store_true",
                        help="drive the in-process MockRobot emulator")
    parser.add_argument("--seconds", type=float, default=None,
                        help="run for a fixed duration then exit (mock runs)")
    args = parser.parse_args()

    cfg_path = args.config
    if not os.path.exists(cfg_path):
        cfg_path = os.path.join(os.path.dirname(__file__), "configs", args.config)
    with open(cfg_path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)

    signal.signal(signal.SIGINT, lambda *_: sys.exit(0))
    if args.mock:
        from booster_gym_torch.deploy.remote_control import ScriptedRemote
        from booster_gym_torch.deploy.sdk import MockRobot

        print("Driving the in-process MockRobot emulator")
        robot = MockRobot()
        remote = ScriptedRemote(vx=0.2)
    else:
        print(f"Connecting to robot at {args.net} ...")
        robot = SdkRobot(net=args.net)
        remote = RemoteControlService()

    mode = UpperBodyMode(args.upper_body)
    with Controller(
        cfg, robot, remote,
        enable_standup=args.standup,
        upper_body_mode=mode,
        sim_time=True,
    ) as controller:
        teleop_client = None
        if mode is UpperBodyMode.TELEOP:
            from booster_gym_torch.deploy.teleop import WebSocketArmClient

            teleop_client = WebSocketArmClient(controller, uri=args.teleop_uri)
            controller.set_teleop_client(teleop_client)
            teleop_client.start()
            print(f"teleop client connecting to {args.teleop_uri}")
        if not args.mock:
            time.sleep(2)
        controller.start_custom_mode(wait=not args.mock)
        controller.start_rl_gait(wait=not args.mock)
        t_end = None if args.seconds is None else time.monotonic() + args.seconds
        try:
            while controller.running:
                if args.mock:
                    robot.tick(10)  # 10 x 2 ms of robot time per loop pass
                controller.run()
                if t_end is not None and time.monotonic() >= t_end:
                    break
            controller.robot.change_mode("damping")
        except KeyboardInterrupt:
            pass
        finally:
            if teleop_client is not None:
                teleop_client.stop()
            controller.cleanup()
            if args.mock:
                arm = controller.dof_pos_latest[:4]
                print(f"mock run done: t={controller.timer.get_time():.2f}s "
                      f"arm_q[0:4]={np.round(arm, 3)} "
                      f"leg_target[0:4]="
                      f"{np.round(controller.dof_target[11:15], 3)}")


if __name__ == "__main__":
    main()
