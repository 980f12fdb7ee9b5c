"""One file per traffic driver, named by the traffic files' "driver": a
`Driver` class (see `serving.Detector` for the interface)."""
