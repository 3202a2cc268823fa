"""Plain references of the benchmark's configurations, one module each,
named by the ``reference`` key of a configuration file. They import
neither JAX nor the program under test."""
