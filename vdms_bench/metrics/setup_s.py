"""Seconds from the start of the process to the first timed submit:
imports, weights and faces drawn on the card, ingest, the model UDF's
registration, kernel builds (the first run in a checkout) and the
warm-up round."""


def read(run):
    return run.setup_s
