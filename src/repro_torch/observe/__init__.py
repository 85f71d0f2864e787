"""The port's copy of ``repro.observe.trace`` (the passive event sink that
``core/ring.py`` reports to); the rest of ``repro.observe`` is not ported."""
