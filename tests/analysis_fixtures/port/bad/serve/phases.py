"""Negative fixture: every phase-transitions violation class."""


class Scheduler:
    def rogue(self, st, somewhere):
        st.phase = "running"                # BAD: Scheduler.rogue is not a
        #                                     declared writer of 'running'
        st.phase = "zombie"                 # BAD: unknown phase
        st.phase = somewhere                # BAD: non-literal phase
