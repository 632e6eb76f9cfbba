/* A C client for two launchers planning on the device
 * (tests/test_torch_launch.py): the hotspot shape, gated so that only a
 * plan can start the work.
 *
 * Rank 0 puts ADLB_HOT_NTASKS tokens (type 1); with ADLB_PUT_ROUTING=home
 * they all land on rank 0's home server. Every other rank consumes them
 * with ADLB_HOT_WORK_US of usleep each. The ranks listed in ADLB_HOT_GATED
 * (comma-separated: those that share rank 0's home server) first wait for
 * a GO unit (type 2) targeted at them, which every other consumer puts to
 * each of them after its first token. Those other consumers are fed only
 * by the planner's matches, so the tokens stay queued until the planner
 * has solved, however fast the world runs. Each rank prints
 *
 *   HOT done=<n>
 *
 * and the world ends by exhaustion.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <adlb/adlb.h>

#define TOKEN 1
#define GO 2
#define MAX_GATED 64

int main(void) {
  int types[2] = {TOKEN, GO};
  int am_server = -1, am_debug = -1, num_apps = 0;
  const char *nsrv_env = getenv("ADLB_NUM_SERVERS");
  int nservers = nsrv_env ? atoi(nsrv_env) : 0;
  int n_tasks = getenv("ADLB_HOT_NTASKS") ? atoi(getenv("ADLB_HOT_NTASKS")) : 200;
  int work_us = getenv("ADLB_HOT_WORK_US") ? atoi(getenv("ADLB_HOT_WORK_US")) : 2000;
  int gated[MAX_GATED], ngated = 0;
  const char *gated_env = getenv("ADLB_HOT_GATED");
  if (gated_env && *gated_env) {
    char *copy = strdup(gated_env), *save = NULL;
    for (char *tok = strtok_r(copy, ",", &save); tok && ngated < MAX_GATED;
         tok = strtok_r(NULL, ",", &save))
      gated[ngated++] = atoi(tok);
    free(copy);
  }
  int rc = ADLB_Init(nservers, 0, 0, 2, types, &am_server, &am_debug,
                     &num_apps);
  if (rc != ADLB_SUCCESS || am_server || am_debug) {
    fprintf(stderr, "hotspot_go: init failed rc=%d\n", rc);
    return 2;
  }
  int me = ADLB_World_rank();
  int done = 0;

  if (me == 0) {
    for (int i = 0; i < n_tasks; i++) {
      rc = ADLB_Put("w", 1, -1, -1, TOKEN, 0);
      if (rc != ADLB_SUCCESS) {
        fprintf(stderr, "hotspot_go: put %d failed rc=%d\n", i, rc);
        return 3;
      }
    }
  } else {
    int am_gated = 0;
    for (int i = 0; i < ngated; i++)
      am_gated |= gated[i] == me;
    int wt, wp, wl, ar;
    char buf[8];
    int ok = 1;
    if (am_gated) {
      int go_req[2] = {GO, ADLB_RESERVE_EOL};
      ok = ADLB_Get_work(go_req, &wt, &wp, buf, (int)sizeof buf, &wl,
                         &ar) == ADLB_SUCCESS;
    }
    int req[2] = {TOKEN, ADLB_RESERVE_EOL};
    while (ok) {
      rc = ADLB_Get_work(req, &wt, &wp, buf, (int)sizeof buf, &wl, &ar);
      if (rc != ADLB_SUCCESS) break; /* NO_MORE_WORK / DONE_BY_EXHAUSTION */
      if (done == 0 && !am_gated) {
        for (int i = 0; i < ngated; i++) {
          rc = ADLB_Put("g", 1, gated[i], -1, GO, 0);
          if (rc != ADLB_SUCCESS) {
            fprintf(stderr, "hotspot_go: GO to %d failed rc=%d\n",
                    gated[i], rc);
            return 3;
          }
        }
      }
      usleep((useconds_t)work_us);
      done++;
    }
  }
  printf("HOT done=%d\n", done);
  ADLB_Finalize();
  return 0;
}
