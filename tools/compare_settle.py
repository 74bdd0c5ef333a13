"""Step the standing-template settle (envs/env.py:251-285: 400 substeps of
the per-env engine, PD hold at the init pose, flat ground) with the JAX
package's engine and with the torch port's engine from the same state,
and print how far they drift apart every 25 substeps.

    JAX_PLATFORMS=cpu python tools/compare_settle.py

Runs on the CPU; needs both JAX and torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vision4leg_tpu.envs import terrain as jterr
from vision4leg_tpu.physics import contact as jcontact
from vision4leg_tpu.physics import engine as jengine
from vision4leg_tpu.robots import a1 as ja1
from vision4leg_tpu.robots import a1_model as ja1_model
from vision4leg_tpu.robots import a1_params as P
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.physics import contact as tcontact
from vision4leg_torch.physics import engine as tengine
from vision4leg_torch.robots import a1 as ta1
from vision4leg_torch.robots import a1_model as ta1_model

STEPS = 400


def main():
  jax.config.update("jax_platforms", "cpu")
  jm, tm = ja1_model.build(dt=0.0025), ta1_model.build(dt=0.0025)
  jdyn, tdyn = ja1.default_dynamics(jm), ta1.default_dynamics(tm)
  cmd = np.asarray(P.INIT_MOTOR_ANGLES, np.float32)
  jcfn = jcontact.make_terrain_contact_fn(*jterr.flat_height_fn(None),
                                          friction=1.0)
  tcfn = tcontact.make_terrain_contact_fn(*tterr.flat_height_fn(),
                                          friction=1.0)
  phys = jengine.zero_state(jm).replace(pos=jnp.array([0.0, 0.0, 0.32]),
                                        joint_q=jnp.asarray(cmd))

  @jax.jit
  def run(rs):
    def body(rs, _):
      rs, _ = ja1.substep(jm, rs, jnp.asarray(cmd), jdyn, jcfn)
      return rs, (rs.phys.pos, rs.phys.joint_qd)
    return jax.lax.scan(body, rs, None, length=STEPS)[1]

  jpos, jqd = (np.asarray(x) for x in run(ja1.init_robot_state(jm, phys)))
  rs = ta1.init_robot_state(tengine.zero_state(tm).replace(
      pos=torch.tensor([0.0, 0.0, 0.32]), joint_q=torch.tensor(cmd)))
  tcmd = torch.tensor(cmd)
  print("substep  |pos diff| m  |joint_qd diff| rad/s  max |joint_qd| (JAX)")
  for i in range(STEPS):
    rs, _ = ta1.substep(tm, rs, tcmd, tdyn, tcfn)
    if i % 25 == 0 or i == STEPS - 1:
      print(f"{i:7d}  {np.abs(rs.phys.pos.numpy() - jpos[i]).max():11.3e}  "
            f"{np.abs(rs.phys.joint_qd.numpy() - jqd[i]).max():20.3e}  "
            f"{np.abs(jqd[i]).max():10.3f}")


if __name__ == "__main__":
  main()
