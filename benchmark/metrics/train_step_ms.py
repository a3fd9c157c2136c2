"""Window ms over the joint train steps completed in it."""


def read(run):
    return 1e3 * run["window_s"] / run["units"] if run["unit"] == "steps" and run["units"] else None
