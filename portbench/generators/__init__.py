"""The general generators. A traffic file (``portbench/traffic/<mix>.json``)
names one in ``"generator"``; the module ``portbench/generators/<name>.py``
gives:

- ``make_inputs(config, traffic, seed) -> inputs``: the unit's inputs from
  the seed, made once in set-up (every unit of a run takes the same ones);
- ``unit_work(config, traffic, inputs) -> dict``: one unit's fixed work,
  its ``user_bytes``;
- ``run_unit(ctx, config, traffic, inputs) -> answer``: one unit through
  the port (``ctx`` is the run's ``ShuffleContext``);
- ``judge(config, traffic, inputs, answers) -> int``: once the window has
  closed, the rows wrong over all the answers, against the plain reference
  in ``portbench/reference/``;
- ``control(config, traffic, inputs) -> answer``: the plain reference in
  the program's place with one guarantee broken, which ``judge`` must find
  wrong.
"""
