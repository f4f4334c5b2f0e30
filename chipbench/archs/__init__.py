"""One module per model type that the accepted prefill kind does not map
(`kinds/prefill_arch.py` finds it by the configuration's `model_type`):
its published keys as the port's configuration, the step's cache as the
reference keeps it, and the operations and bytes its metrics count."""
