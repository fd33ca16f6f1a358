"""Traffic: each mix is a data file ``<traffic>.json`` whose ``kind``
names its generator, the module ``<kind>.py`` here, which sets up the
program for the mix, drives the window and checks what it served."""
