"""Per-layer metrics' readers with logic of their own, one module a
metric: metrics/<metric>.py defines `read(run)`, which returns the value
or None where the run has nothing to read.  A metric without such a file
is read by the shared reader its name picks (`registry.reader`)."""
