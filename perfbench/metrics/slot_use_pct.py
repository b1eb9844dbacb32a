"""Share of slot-steps that yield an output token: output tokens received
in the window over (decode steps completed in the window x slots). The
engine's ``decode_calls`` counts every decode step it launches, block
waves and admission's solo steps alike; a solo step feeds one prompt
token and yields no output token."""


def read(run):
    if not run.decode_calls:
        return None
    return 100.0 * run.tokens_out / (run.decode_calls * run.n_slots)
