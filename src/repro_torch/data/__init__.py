"""The reference's data pipeline (``repro/data``), numpy only: the port
carries a verbatim copy, so its batches are the reference's bit for
bit."""
