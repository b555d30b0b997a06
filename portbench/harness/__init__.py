"""The benchmark's general machinery: environment, file lookup by name,
seeded weights and traffic, tracing and the result line. Nothing here
belongs to one configuration, traffic mix or metric."""
