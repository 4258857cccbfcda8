"""Part of the munit_tpu_torch port; see the package docstring."""
