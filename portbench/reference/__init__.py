"""The plain reference that decides whether a run is correct.

Plain PyTorch in float64, written from the semantics of an ANN index and
not from the program: exact nearest neighbours by brute force
(:mod:`.knn`), what every row of an RNN-Descent graph must satisfy
(:mod:`.graph`) and what every search answer must satisfy (:mod:`.results`).
It imports nothing of the program and takes nothing the program made but
the outputs it judges: the corpus and queries come from the benchmark.
"""
