"""Kinds of run. A traffic mix names its driver (``"driver"``);
``gpubench.drivers.<driver>.run(run, t0=, device=)`` fills the
:class:`gpubench.bench.Run` and returns the result's ``device`` object."""
