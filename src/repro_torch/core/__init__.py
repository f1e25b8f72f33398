"""Core algorithms of the port: distances, graph merges, RNG prune,
RNN-Descent build, beam search, evaluation."""
