"""The port's copy of the numpy graph store, LDBC generator and engine."""
