"""Scene generators, one module per generator, found by the name in a
configuration's ``scene.generator`` (``named.find("scenes", ...)``).
Each has:

- ``program_scene(config, samples) -> dict``: the scene JSON that the
  program loads, with its asset files written (``assets/files.py``);
- ``reference_data(config)``: what the reference builds its scene from,
  made from the generator's own data, never from the files the program
  reads (computed once per run);
- ``reference_scene(config, data, samples) -> RefScene``: the reference's
  scene (``reference/scene.py``)."""
