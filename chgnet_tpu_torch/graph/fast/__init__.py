"""The port's native (C++) graph builder."""
