"""The share of the users a round's refresh touches: 100 × the engine's
``EngineStats.n_touched`` (touched users summed over ingests) over the
window's rounds times the users. None where the program keeps no such
counter."""


def read(ctx, peaks):
    counter = ctx.get("touched_counter")
    if not counter or not counter[1]:
        return None
    touched, rounds = counter
    return 100.0 * touched / (rounds * ctx["n_users"])
