"""One reader per metric family: the file named by the part of the
metric's name before its first dot (`device_idle.py` serves
`device_idle.detect` and `device_idle.stream`).  A reader has `UNIT` and
`read(run, name)`, which returns the metric's value from the run's
records (`harness.Run`), or None when it finds nothing to read: the
harness then leaves the metric out of the line."""
