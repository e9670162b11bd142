"""The reference's ``examples/`` scripts as runnable modules of the port.

Each is the counterpart of one script, with its arguments plus
``--device`` (``cuda`` unless named; with no GPU and no device named it
raises)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.lock_playground
    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
    PYTHONPATH=src python -m repro_torch.examples.serve_continuous_batching
    PYTHONPATH=src python -m repro_torch.examples.train_moe --steps 300

Each module's work is in ``main(argv)``, which prints what the script
prints and returns it, so that a caller can check it.
"""
