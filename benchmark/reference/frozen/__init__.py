"""Frozen copies of the port's plain versions, copied from
`vision4leg_torch` when the benchmark was defined and left as they were
but for their imports, made relative, and cut to what the benchmark
calls: the env-last physics window and its
cost count (`ops/physics_envlast.py`, `ops/window_cost.py`), the A1 model
and its parameters, the per-env engine (the reset's settle), its state
and maths, the robot's delayed sensors, the task, the flat terrains'
camera and the terrain's moving boxes.  They are the yardstick's,
so that a change to the program cannot move it."""
