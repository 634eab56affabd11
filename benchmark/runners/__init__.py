"""Runners, one module each, found by the ``runner`` a configuration
names (``runners/<runner>.py``).  A runner module has ``Runner(cell,
seed, *, device, trace)`` with ``devices``, ``setup()``, ``setup_info``,
``window(seconds, trace)``, ``host_samples()`` and ``release()``; it may
also have ``judge`` and ``control`` to stand in for those of
``correct.py``.  A new entry point or way of driving the program is a new
module here, and no edit of one that is there."""
