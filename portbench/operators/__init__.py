"""One builder per operator kind: ``<kind>.py`` defines ``build(spec)``,
which returns the configuration's operator as a float64 SciPy CSR matrix,
built from its sizes alone.  The benchmark hands that matrix to the program
and to the reference alike."""
