"""The plain reference of the benchmark's configurations: a frozen copy of
the plain PyTorch path of booster_gym_torch (the robot model, the physics,
the terrain, the T1 task, the actor-critic and the autograd PPO update),
with no CUDA kernel, no process group and no import of the program.  Later
changes to the program do not change it.  Every module keeps the program's
names, so that a reader can hold the two side by side."""
