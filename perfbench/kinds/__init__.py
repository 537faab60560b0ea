"""Traffic kinds. A traffic file names its ``kind``; ``kinds/<kind>.py``
gives ``setup(run)``, ``window(run, seconds)`` and ``verify(run)``, and
reads everything else from the traffic file's parameters."""
