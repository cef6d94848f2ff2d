"""The plain reference the benchmark's ``correct`` is judged against."""
