"""The paper's applications built on the port's model of computation."""
