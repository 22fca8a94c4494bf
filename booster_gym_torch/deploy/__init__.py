"""Robot deployment stack for the Booster T1 (the port's copy of
booster_gym_tpu/deploy, with the port's imports).

Python runtime around the Booster Robotics DDS SDK (same role as the
reference's deploy/ tree), re-designed around a RobotInterface abstraction
so the full control stack — policy wrappers, the two-thread controller, the
standup state machine — runs identically against the real SDK, Webots, or
the in-process MockSDK used by the test-suite.

It imports neither JAX nor the JAX package, so a policy exported by
booster_gym_torch.export goes from training to the robot with no JAX
installed; its behaviour is the JAX package's deploy stack, line for line.
It runs on the CPU, as on the robot: see policy.py.
"""
