"""The harness: what a run measures (spec), its inputs (inputs), the system
under test (system) and the reduction of its trace (trace)."""
