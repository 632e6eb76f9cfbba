/* Fortran binding: thin by-reference shims over the C API, the native
 * equivalent of the reference's src/adlbf.c:6-103.  Name mangling follows
 * the GNU default (lowercase + trailing underscore); builds that need a
 * different convention define ADLB_FC_GLOBAL, which CMake wires up via
 * FortranCInterface when a Fortran compiler is present (reference
 * CMakeLists.txt:62-68).  Constants for Fortran programs live in
 * include/adlb/adlbf.h, generated from adlb.h by scripts/genfh.py.
 */
#include <adlb/adlb.h>

/* CMake defines ADLB_HAVE_FC_MANGLING when a Fortran compiler was found
 * and FortranCInterface generated adlb_fc_mangling.h with the compiler's
 * true convention (reference CMakeLists.txt:62-68). */
#ifdef ADLB_HAVE_FC_MANGLING
#include "adlb_fc_mangling.h"
#endif

#ifndef ADLB_FC_GLOBAL
#define ADLB_FC_GLOBAL(lc, UC) lc##_
#endif

/* the build compiles this file with g++ alongside libadlb.cpp; the shims
 * must keep unmangled Fortran-visible names either way */
#ifdef __cplusplus
extern "C" {
#endif

void ADLB_FC_GLOBAL(adlb_init, ADLB_INIT)(int *nservers, int *use_debug_server,
                                          int *aprintf_flag, int *ntypes,
                                          int type_vect[], int *am_server,
                                          int *am_debug_server,
                                          int *num_app_ranks, int *ierr) {
  *ierr = ADLB_Init(*nservers, *use_debug_server, *aprintf_flag, *ntypes,
                    type_vect, am_server, am_debug_server, num_app_ranks);
}

void ADLB_FC_GLOBAL(adlb_server, ADLB_SERVER)(double *hi_malloc,
                                              double *periodic_log_interval,
                                              int *ierr) {
  *ierr = ADLB_Server(*hi_malloc, *periodic_log_interval);
}

void ADLB_FC_GLOBAL(adlb_debug_server, ADLB_DEBUG_SERVER)(double *timeout,
                                                          int *ierr) {
  *ierr = ADLB_Debug_server(*timeout);
}

void ADLB_FC_GLOBAL(adlb_put, ADLB_PUT)(void *work_buf, int *work_len,
                                        int *target_rank, int *answer_rank,
                                        int *work_type, int *work_prio,
                                        int *ierr) {
  *ierr = ADLB_Put(work_buf, *work_len, *target_rank, *answer_rank,
                   *work_type, *work_prio);
}

void ADLB_FC_GLOBAL(adlb_reserve, ADLB_RESERVE)(int *req_types, int *work_type,
                                                int *work_prio,
                                                int *work_handle,
                                                int *work_len,
                                                int *answer_rank, int *ierr) {
  *ierr = ADLB_Reserve(req_types, work_type, work_prio, work_handle, work_len,
                       answer_rank);
}

void ADLB_FC_GLOBAL(adlb_ireserve, ADLB_IRESERVE)(int *req_types,
                                                  int *work_type,
                                                  int *work_prio,
                                                  int *work_handle,
                                                  int *work_len,
                                                  int *answer_rank,
                                                  int *ierr) {
  *ierr = ADLB_Ireserve(req_types, work_type, work_prio, work_handle,
                        work_len, answer_rank);
}

void ADLB_FC_GLOBAL(adlb_get_reserved, ADLB_GET_RESERVED)(void *work_buf,
                                                          int *work_handle,
                                                          int *ierr) {
  *ierr = ADLB_Get_reserved(work_buf, work_handle);
}

void ADLB_FC_GLOBAL(adlb_get_reserved_timed,
                    ADLB_GET_RESERVED_TIMED)(void *work_buf, int *work_handle,
                                             double *time_on_queue,
                                             int *ierr) {
  *ierr = ADLB_Get_reserved_timed(work_buf, work_handle, time_on_queue);
}

void ADLB_FC_GLOBAL(adlb_begin_batch_put,
                    ADLB_BEGIN_BATCH_PUT)(void *common_buf, int *len_common,
                                          int *ierr) {
  *ierr = ADLB_Begin_batch_put(common_buf, *len_common);
}

void ADLB_FC_GLOBAL(adlb_end_batch_put, ADLB_END_BATCH_PUT)(int *ierr) {
  *ierr = ADLB_End_batch_put();
}

void ADLB_FC_GLOBAL(adlb_set_problem_done, ADLB_SET_PROBLEM_DONE)(int *ierr) {
  *ierr = ADLB_Set_problem_done();
}

void ADLB_FC_GLOBAL(adlb_set_no_more_work, ADLB_SET_NO_MORE_WORK)(int *ierr) {
  *ierr = ADLB_Set_no_more_work();
}

void ADLB_FC_GLOBAL(adlb_info_get, ADLB_INFO_GET)(int *key, double *value,
                                                  int *ierr) {
  *ierr = ADLB_Info_get(*key, value);
}

void ADLB_FC_GLOBAL(adlb_info_num_work_units,
                    ADLB_INFO_NUM_WORK_UNITS)(int *work_type, int *num_units,
                                              int *num_bytes,
                                              int *max_wq_count, int *ierr) {
  *ierr = ADLB_Info_num_work_units(*work_type, num_units, num_bytes,
                                   max_wq_count);
}

void ADLB_FC_GLOBAL(adlb_finalize, ADLB_FINALIZE)(int *ierr) {
  *ierr = ADLB_Finalize();
}

void ADLB_FC_GLOBAL(adlb_abort, ADLB_ABORT)(int *code, int *ierr) {
  *ierr = ADLB_Abort(*code);
}

void ADLB_FC_GLOBAL(adlb_world_rank, ADLB_WORLD_RANK)(int *rank) {
  *rank = ADLB_World_rank();
}

void ADLB_FC_GLOBAL(adlb_world_size, ADLB_WORLD_SIZE)(int *size) {
  *size = ADLB_World_size();
}

#ifdef __cplusplus
} /* extern "C" */
#endif
