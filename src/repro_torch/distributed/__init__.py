"""Multi-rank serving: the ambient mesh and its collectives (`ctx`), and
the sharding rules and placements (`sharding`)."""
