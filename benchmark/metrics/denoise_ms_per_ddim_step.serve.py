"""The denoise stage's ms (from the program's stage_hook, which the
traced run ends with a synchronize) over its DDIM steps, the mean over the
window's requests."""


def read(run):
    stages = run["spans"].get("stages") or []
    at = {}
    per = []
    for name, t in stages:
        at[name] = t
        if name == "denoise" and "render" in at:
            per.append(t - at["render"])
    if not per:
        return None
    return 1e3 * sum(per) / len(per) / run["traffic"]["ddim_steps"]
