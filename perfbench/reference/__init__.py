"""The plain reference that decides ``correct``: NumPy only.  It imports
nothing of the program and takes nothing the program made; it works from the
bases the harness generated, the guides and planted sites the traffic drew,
and the tables the program returned (which it only judges)."""
