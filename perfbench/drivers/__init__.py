"""Family drivers: one module a kind of traffic, named by the traffic file's
``driver`` key.  Each module defines ``build(config, traffic, seed, device,
system=None)``, which returns an object with ``setup()``, ``window(seconds,
span)``, ``end_to_end(stats)``, ``release()`` and ``check()`` (see
``perfbench/harness.py``), and ``CONTROL(config, device)``, the class of its
control system."""
