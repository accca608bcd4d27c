"""Loading of the serving artifact (training itself is not ported)."""
