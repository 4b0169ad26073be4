"""The harness: cell lookup, genome and traffic generation, the measured
window, the trace reading and the work arithmetic."""
