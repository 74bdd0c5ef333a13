"""How the benchmark builds the program under test, one module a kind of
job, named by a configuration's `program` key (`programs/<name>.py`).

A module here gives:
  build_agent(cell, seed, device)  the agent whose `train_epoch` the
                                   window drives, built through the
                                   program's own starter path;
  env_class()                      the env class whose resets the check
                                   records from the agent's build on;
  fault_targets()                  the program's classes and modules that
                                   harness/faults.py plants its faults on;
  Capture                          the class that records the first
                                   epoch for the check (harness/check.py).
"""
