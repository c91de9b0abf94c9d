"""Mean recall@k of the recall steps' answers against the reference's
exact k nearest over the rows live at that step (`check.recall_of`)."""


def read(ctx):
    return ctx.recall
