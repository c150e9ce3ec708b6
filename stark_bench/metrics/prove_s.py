"""prove_s: the window's seconds a proof, from the first job's start to the
last job's end, over the jobs completed (a failed job's time counts, the job
does not): a time a step over all the work of the window, so a stall shows."""

UNIT = "s"


def read(rec):
    done = len(rec.jobs) - rec.failed
    if not rec.jobs or done < 1:
        return None
    return (rec.jobs[-1][1] - rec.jobs[0][0]) / done
