"""Host milliseconds a query spends in seeding: the host clock around the
seeder's ``add_query`` and ``add_target`` (the seeding machine runs in
``add_target``), summed over the window, per query (program span)."""

SPANS = {"seeding": ["exonerate_tpu_torch.seeds.seeder:Seeder.add_query",
                     "exonerate_tpu_torch.seeds.seeder:Seeder.add_target"]}


def read(ctx):
    runs = ctx.spans.get("seeding")
    if not runs:
        return None
    return 1e3 * sum(d for _, d in runs) / ctx.units
