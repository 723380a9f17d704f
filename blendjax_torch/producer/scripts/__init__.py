"""Producer scripts of the port's registered environments (copied from
``blendjax/producer/scripts``). They live under the producer package, not
under :mod:`blendjax_torch.env`, so a spawned producer never imports the
env package's Gymnasium registration. Each module is importable and runs
as a launcher script (the launcher runs the file, with the root that holds
``blendjax_torch`` on ``PYTHONPATH``)."""
