"""The benchmark's plain reference: a float64 NumPy detector, its own
raw-byte conversion, overlap-save unfold and ``.card`` decode, and the
comparison that decides a run's ``correct``.  Nothing here imports the
program."""
