"""One module a model: the harness (fmbench/run.py ``load_model``) loads
``fmbench/models/<model>.py`` by the configuration file's ``model`` key,
else its ``conf``'s ``loss``, else ``fm``. PERF.md §4 gives the interface."""
